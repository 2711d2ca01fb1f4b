"""Roofline terms of a step on H100s (port of ``repro.launch.roofline``).

Three terms per (arch x shape x mesh), in seconds, each per device:

  compute    = FLOPs            / 989e12 bf16 FLOP/s (67e12 float32)
  memory     = HBM bytes        / 3.35e12 B/s
  collective = collective bytes / 450e9 B/s (NVLink 4, one direction)

The rates are the H100 SXM data sheet's (dense bf16 and float32 tensor
throughput without sparsity, HBM3 bandwidth, and half of NVLink's 900
GB/s, which counts both directions), the ones ``chip_smoke.py`` bounds
its kernels with.

The port compiles nothing, so nothing here parses HLO:

* FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode`` over
  the port's own forward (and backward, for a train cell) on ``meta``
  tensors (``launch.dryrun``).  It counts the matrix products
  (``mm``/``bmm``/attention); elementwise work (norms, the Mamba and
  xLSTM scans) is not counted.
* HBM bytes are :func:`analytic_bytes`, the JAX package's analytic floor.
* Collective bytes are the port's own count of what its step runs
  (:func:`collective_bytes`; the design is ``PERF.md`` §3): per step and
  per device, in ring wire bytes ((n-1)/n of the buffer for an
  all-gather, a reduce-scatter or an all-to-all over n ranks, 2(n-1)/n
  for an all-reduce), each leaf sharded over ``data`` all-gathered once
  (it is kept whole for every microbatch and for the backward) and its
  float32 gradient reduce-scattered, then all-reduced over the other
  batch axes (``pod``); each replicated leaf's float32 gradient
  all-reduced over every batch axis.  A leaf's buffer is its bytes
  divided by its non-batch axes' shard factor.  A train cell adds the
  collectives over ``model`` that the step runs, kind by kind
  (:func:`tensor_parallel_bytes`: a split block's forward, its
  recomputation and its backward, the residual stream's gathers and
  reduce-scatters where it is split by positions (``seq_sp``), the cut
  heads' and uneven Mamba/xLSTM layouts' gathers, the MoE's router
  gather, load statistics, all-to-alls and row gather, the
  vocab-parallel embedding and loss, the gradient norm).  Inference
  cells all-gather the sharded weights once; the port does not serve
  over ``model``, so they run no all-to-all.

``model_flops`` (6 N D train, 2 N D inference, N the active parameters)
and ``analytic_bytes`` are copies of the JAX functions.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

from repro_torch.sharding.rules import (PartitionSpec, mesh_axis_sizes,
                                        spec_axes)

#: dense tensor throughput per card, FLOP/s (H100 SXM data sheet)
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
HBM_BW = 3.35e12          # B/s per card (H100 SXM data sheet)
NVLINK_BW = 450e9         # B/s per card, one direction (of 900 GB/s)

#: the batch axes: a gradient is reduced over every one present
BATCH_AXES = ("pod", "data")

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def _ring(n: int) -> float:
    return (n - 1) / n


def tensor_parallel_bytes(cfg, specs: Dict[str, PartitionSpec], mesh,
                          batch: int, seq: int, microbatches: int = 1,
                          optimizer: str = "adamw", rules=None
                          ) -> Dict[str, Dict[str, int]]:
    """{kind: {"calls", "bytes"}} for each collective kind over ``model``
    (``tensor_parallel.KINDS``) that one train step hands over on
    one device (the whole buffers, before any ring factor: an
    all-gather's output, a reduce-scatter's input), ``batch`` x ``seq``
    tokens on that device, with the parameter ``specs`` ({name:
    PartitionSpec}) on ``mesh`` under ``rules`` (``DEFAULT_RULES`` when
    None).  Per microbatch of T tokens, each block recomputed in the
    backward pass (remat) up to the last activation the backward saved.

    The residual stream, each of a layer's two blocks (its sequence
    mixer, whose output the recomputation needs for the channel mixer
    that follows it, and its MLP, MoE or up/down, whose output it does
    not): where the rules split the stream by positions over ``model``
    (``tensor_parallel.seq_parallel``), its norm weight's gradient
    all-reduced, its normed input (T x d_model) all-gathered forward and
    recomputed and its output's gradient all-gathered backward; where
    its work is split, its input's gradient reduce-scattered and its
    output reduce-scattered forward (and recomputed: the mixer); on a
    whole stream, where the work is split, all-reduces in place of those
    reduce-scatters.  Beyond the stream:

    * heads split (self- or cross-attention: the image K/V are projected
      from the replicated embeddings, with no collective): with QK-norm,
      the two norm weights' gradients; where heads are cut across ranks
      (a head or the query/KV pairing does not fall whole on a rank),
      each split projection weight (d_model x width) all-gathered
      forward and recomputed and its gradient reduce-scattered; a whole
      one's gradient all-reduced;
    * a Mamba block whose ``d_inner`` is split: the ``in_proj`` product
      (T x 2 d_inner / model) exchanged into this rank's channels by
      all-to-all forward, recomputed and backward; the ``x_proj``
      product (T x (2 N + 1)) all-reduced forward, recomputed and
      backward.  Where only ``in_proj``'s columns split (its input is
      split work, its output whole), the product all-gathered forward
      and recomputed (T x 2 d_inner);
    * an xLSTM block whose heads are split: for the sLSTM the float32
      gate product (T x 4 attn_dim / model) exchanged by all-to-all
      forward, recomputed and backward.  Where the heads fall across
      ranks, the split projections all-gathered forward and recomputed
      and their gradients reduce-scattered (the mLSTM's ``wq``/``wk``/
      ``wv``, d_model x attn_dim; the sLSTM's float32 ``w_gates``,
      d_model x 4 attn_dim, and ``b_gates``, 4 x attn_dim) and the whole
      ones' gradients all-reduced (``wi``/``wf``, float32 d_model x
      heads; ``r_gates``, float32 4 x heads x head_dim^2);
    * a MoE block routing one dispatch group a model rank (G of the
      data rank's T tokens, as ``models.moe._num_groups`` over the whole
      mesh): on a whole stream its input's gradient all-reduced and the
      combined rows all-gathered forward (the block's last op: not
      recomputed), on a split one its stream as a split block's; the
      router (float32) all-gathered forward and recomputed and its
      gradient reduce-scattered (all-reduced when whole); the load
      statistics (2 x E float32) all-reduced forward and recomputed;
      with the experts split, the (E, C, d_model) buffer exchanged by
      all-to-all twice forward, twice recomputed and twice backward (C
      the capacity of a group of T / model tokens), else the three
      expert weights' gradients all-reduced;
    * a MoE block routing fewer groups than model ranks (a whole
      stream) with its experts split: its input's gradient all-reduced,
      the router all-gathered forward and recomputed, the experts'
      outputs (E, G x C, d_model) all-gathered forward and recomputed;
      with the experts whole, none;
    * the embedding and head: on a split stream, the final norm weight's
      gradient all-reduced, the embedding's sum reduce-scattered forward
      and its gradient all-gathered (a whole table: the gradient only;
      the audio frontend's frames are cut, no collective), the head's
      input all-gathered forward and, with the vocabulary split, its
      gradient reduce-scattered; on a whole stream with the vocabulary
      split, the embedding's sum forward (none with the audio frontend)
      and the head input's gradient all-reduced.  With the vocabulary
      split, per ``LOSS_CHUNK`` slice of the sequence the log-sum-exp's
      max (float32) and its sum of exponentials stacked with the target
      logit (2 x float32), forward and again recomputed;

    and once a step (``optimizer``), one float32 scalar all-reduced per
    set of the mesh axes that gradients split over ``model`` are split
    over (the gradient norm; Adafactor's gradients are whole over
    ``data``, so one), and for Adafactor each statistic group split over
    ``model`` on one of its last two dimensions: split on the last, its
    row statistic's partial sums (float32, the stack without its last
    dimension) all-reduced; split on the second to last, its column
    statistic's (the stack without that dimension) and the row
    statistic's mean (the stack without its last two dimensions)."""
    from repro_torch.configs.base import MLSTM, SLSTM, XATTN
    from repro_torch.models.model import LOSS_CHUNK
    from repro_torch.models.transformer import (ATTN_KINDS, MAMBA_KINDS,
                                                MOE_KINDS)
    from repro_torch.sharding.rules import DEFAULT_RULES, spec_for
    from repro_torch.sharding.tensor_parallel import KINDS, split_over_model

    sizes = mesh_axis_sizes(mesh)
    n, data = sizes.get("model", 1), sizes.get("data", 1)
    out = {k: {"calls": 0, "bytes": 0} for k in KINDS}

    def moe_groups(total: int) -> int:
        """``models.moe._num_groups`` of ``total`` tokens on ``mesh``."""
        g = math.prod(sizes.values())
        while g > 1 and total % g:
            g //= 2
        return max(g, 1)

    def add(kind, calls, nbytes):
        out[kind]["calls"] += calls * microbatches
        out[kind]["bytes"] += calls * int(nbytes) * microbatches

    def split(name, dim):
        return name in specs and split_over_model(specs[name], dim)
    item = {"float32": 4, "bfloat16": 2, "float16": 2}[cfg.dtype]
    d, hd = cfg.d_model, cfg.head_dim
    rows = batch // microbatches
    tokens = rows * seq
    act = tokens * d * item
    sp = n > 1 and split_over_model(spec_for(
        (rows, seq, d), ("batch", "seq_sp", "embed"), mesh,
        DEFAULT_RULES if rules is None else rules), 1)

    def stream(into: bool, back: bool, outs: int):
        """A block's residual stream: ``into`` its input read by split
        work, ``back`` its output summed from split work, ``outs`` its
        output's forward calls (2 where recomputed)."""
        if sp:
            add("all-reduce", 1, d * item)
            add("all-gather", 3, act)
            add("reduce-scatter", into + back * outs, act)
        else:
            add("all-reduce", into + back * outs, act)

    def gathered(nbytes, calls=1):
        """``calls`` weights of ``nbytes`` gathered whole: all-gathered
        forward and recomputed, their gradients reduce-scattered."""
        add("all-gather", 2 * calls, nbytes)
        add("reduce-scatter", calls, nbytes)
    pattern = cfg.block_pattern
    for i in range(cfg.num_layers if n > 1 else 0):
        pre = f"blocks.{i}."
        kind = pattern[i % len(pattern)]
        if kind in ATTN_KINDS or kind == XATTN:
            mixer = pre + ("xattn." if kind == XATTN else "attn.")
            heads = split(mixer + "wq", 1)
            stream(heads, heads, 2)
            if heads and cfg.qk_norm:
                add("all-reduce", 2, hd * item)
            wk_split = split(mixer + "wk", 1)
            if heads and (cfg.num_heads % n or cfg.num_kv_heads % n
                          or not wk_split):
                for width, is_split in ((cfg.attn_dim, True),
                                        (cfg.kv_dim, wk_split),
                                        (cfg.kv_dim, wk_split)):
                    if is_split:
                        gathered(d * width * item)
                    else:
                        add("all-reduce", 1, d * width * item)
        elif kind in MAMBA_KINDS:
            channels = split(pre + "mamba.conv_w", 1)
            cols = split(pre + "mamba.in_proj", 1)
            stream(cols, channels, 2)
            if channels:
                add("all-to-all", 3, tokens * 2 * cfg.d_inner // n * item)
                add("all-reduce", 3,
                    tokens * (2 * cfg.ssm_state_dim + 1) * item)
            elif cols:
                add("all-gather", 2, tokens * 2 * cfg.d_inner * item)
        else:
            heads = split(pre + "wo_out", 0)
            stream(heads, heads, 2)
            ad = cfg.attn_dim
            if kind == SLSTM and heads and split(pre + "r_gates", 1):
                add("all-to-all", 3, tokens * 4 * ad // n * 4)
            elif kind == SLSTM and heads:
                gathered(d * 4 * ad * 4)
                gathered(4 * ad * 4)
                add("all-reduce", 1, 4 * cfg.num_heads * hd * hd * 4)
            elif kind == MLSTM and heads and not split(pre + "wi", 1):
                gathered(d * ad * item, 3)
                add("all-reduce", 2, d * cfg.num_heads * 4)
        if kind in (SLSTM, MLSTM):
            up = split(pre + "up", 1)
            stream(up, up, 1)
        elif kind not in MOE_KINDS:
            ff = split(pre + "mlp.w_gate", 1)
            stream(ff, ff, 1)
        else:
            E, K = cfg.num_experts, cfg.experts_per_token
            router = d * E * 4
            experts_split = split(pre + "moe.experts.w_gate", 0)
            G = max(1, moe_groups(tokens * data) // data)
            if G < n:
                if experts_split:
                    C = max(1, math.ceil(tokens // G * K / E
                                         * cfg.moe_capacity_factor))
                    add("all-reduce", 1, act)
                    add("all-gather", 2, router)
                    add("all-gather", 2, E * G * C * d * item)
                continue
            if sp:
                stream(True, True, 1)
            else:
                add("all-reduce", 1, act)
                add("all-gather", 1, act)
            add("all-reduce", 2, 2 * E * 4)
            if experts_split:
                C = max(1, math.ceil(tokens // n * K / E
                                     * cfg.moe_capacity_factor))
                gathered(router)
                add("all-to-all", 6, E * C * d * item)
            else:
                add("all-reduce", 1, router)
                add("all-reduce", 3, E * d * cfg.d_ff * item)
    vocab = split("embed", 0) or split("head", 1)
    if sp:
        add("all-reduce", 1, d * item)
        if not cfg.audio_frontend:
            add("reduce-scatter", split("embed", 0), act)
            add("all-gather", 1, act)
        add("all-gather", 1, act)
        add("reduce-scatter", vocab, act)
    elif vocab:
        add("all-reduce", 1 if cfg.audio_frontend else 2, act)
    if vocab:
        chunks = -(-seq // min(LOSS_CHUNK, seq))
        add("all-reduce", 2 * chunks, tokens * 4)
        add("all-reduce", 2 * chunks, 2 * tokens * 4)
    adafactor = optimizer == "adafactor"
    groups = {tuple(sorted({a for e in s for a in spec_axes(e)
                            if a == "model" or not adafactor}))
              for s in specs.values()}
    norms = sum("model" in g for g in groups)
    out["all-reduce"]["calls"] += norms
    out["all-reduce"]["bytes"] += 4 * norms
    if adafactor and n > 1:
        for calls, nbytes in _adafactor_stats(cfg, specs):
            out["all-reduce"]["calls"] += calls
            out["all-reduce"]["bytes"] += nbytes
    return out


def _adafactor_stats(cfg, specs):
    """(calls, bytes) of the all-reduces over ``model`` of each Adafactor
    statistic group whose parameters are split over ``model`` on one of
    their last two dimensions (``optimizer.apply_updates``'s ``split``):
    the row statistic's partial sums for the last, the column
    statistic's and the row statistic's mean for the second to last."""
    from repro_torch.models.model import LM
    from repro_torch.sharding.tensor_parallel import split_over_model
    from repro_torch.training.optimizer import _groups
    shapes = {k: tuple(p.shape) for k, p in
              LM(cfg, device="meta").named_parameters()}
    for group, names in _groups(shapes, len(cfg.block_pattern)).items():
        full = shapes[names[0]]
        if group.startswith("blocks."):
            full = (len(names), *full)
        if len(full) < 2:
            continue
        spec, nd = specs.get(names[0], ()), len(shapes[names[0]])
        if nd and split_over_model(spec, nd - 1):
            yield 1, math.prod(full[:-1]) * 4
        elif nd > 1 and split_over_model(spec, nd - 2):
            yield 2, (math.prod(full[:-2] + full[-1:])
                      + math.prod(full[:-2])) * 4


def collective_bytes(params: Dict[str, object],
                     specs: Dict[str, PartitionSpec], mesh, kind: str,
                     tp=None) -> Dict[str, float]:
    """Wire bytes per device and step, by collective, of the port's
    execution: ``params`` {name: tensor (meta)} with their ``specs`` on
    ``mesh``; ``kind`` the cell's ("train", "prefill", "decode"); ``tp``
    a train step's collectives over ``model``
    (:func:`tensor_parallel_bytes`), each kind's buffers at its ring
    factor.  The port does not serve over ``model``: an inference cell
    runs no all-to-all."""
    sizes = mesh_axis_sizes(mesh)
    batch = [a for a in BATCH_AXES if a in sizes]
    out = {k: 0.0 for k in COLLECTIVES}
    for name, p in params.items():
        axes = [a for e in specs[name] for a in spec_axes(e)]
        other = math.prod(sizes[a] for a in axes if a not in batch)
        n_gather = math.prod(sizes[a] for a in axes if a in batch)
        n_reduce = math.prod(sizes[a] for a in batch if a not in axes)
        numel = math.prod(p.shape) / other
        buf = numel * p.element_size()
        out["all-gather"] += buf * _ring(n_gather)
        if kind == "train":
            g = numel * 4                                  # float32 grads
            out["reduce-scatter"] += g * _ring(n_gather)
            out["all-reduce"] += g / n_gather * 2 * _ring(n_reduce)
    if kind == "train" and tp:
        ring = _ring(sizes.get("model", 1))
        for k, v in tp.items():
            out[k] += v["bytes"] * ring * (2 if k == "all-reduce" else 1)
    return out


@dataclass
class RooflineReport:
    """Every quantity is PER DEVICE except ``model_flops`` (global,
    divided by ``chips`` where compared).  The JSON keys are the JAX
    report's: ``hlo_flops`` holds the FLOPs counted on meta tensors
    divided by ``chips`` (there is no HLO), ``hlo_bytes`` the analytic
    HBM bytes, ``coll_bytes`` :func:`collective_bytes`."""
    arch: str
    shape: str
    mesh: str
    chips: int
    model_flops: float                 # analytic useful FLOPs / step (global)
    hlo_flops: float                   # per device, counted on meta tensors
    hlo_bytes: float                   # per device, analytic
    coll_bytes: Dict[str, float]
    bytes_per_device: Dict[str, float]
    flops_source: str = "flop_counter"
    peak_flops: float = PEAK_FLOPS["torch.bfloat16"]

    analytic_bytes_dev: float = 0.0    # analytic HBM-traffic floor / device

    @property
    def coll_bytes_total(self) -> float:
        return sum(self.coll_bytes.values())

    @property
    def compute_s(self) -> float:
        # the analytic count is a floor: the counter skips elementwise work
        return max(self.hlo_flops, self.model_flops / self.chips) \
            / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def analytic_memory_s(self) -> float:
        return self.analytic_bytes_dev / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_total / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def usefulness(self) -> float:
        """MODEL_FLOPS / counted FLOPs: how much counted compute is useful."""
        return (self.model_flops / self.chips) / self.hlo_flops \
            if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / max(term): the fraction of the roofline."""
        peak = self.model_flops / self.chips / self.peak_flops
        denom = max(self.compute_s, self.memory_s, self.collective_s)
        return peak / denom if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "model_flops": self.model_flops,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes,
            "coll_bytes_total": self.coll_bytes_total,
            "bytes_per_device": self.bytes_per_device,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "analytic_memory_s": self.analytic_memory_s,
            "bottleneck": self.bottleneck, "usefulness": self.usefulness,
            "roofline_fraction": self.roofline_fraction,
            "flops_source": self.flops_source,
        }


def analytic_bytes(cfg, shape, chips: int, microbatches: int = 1) -> float:
    """Per-device analytic HBM traffic per step (a floor, not a fit):

    train:   params fwd read + bwd read (x microbatches, FSDP regather) +
             grads + optimizer m/v read+write + activation carry rw
    prefill: params once + activations (~12 bytes/token/d_model/layer) + KV write
    decode:  params once + full KV/state cache read + write of one slot
    """
    n_params = cfg.param_count()
    p_bytes = 2.0 * n_params / chips                     # bf16 shard
    d = cfg.d_model
    L = cfg.num_layers
    attn_layers = sum(k in ("attn", "attn_moe", "xattn")
                      for k in cfg.block_pattern) * cfg.pattern_repeats
    kv_per_tok = 2 * cfg.kv_dim * 2 * attn_layers        # bytes, bf16

    if shape.kind == "train":
        tokens_dev = shape.tokens / chips
        act = 12.0 * tokens_dev * d * L * 2 / 16         # remat carry + block io (SP/16)
        opt = 4.0 * 2 * n_params / chips * 2             # m,v f32 read+write
        grads = 4.0 * n_params / chips
        return p_bytes * (2 * microbatches) + grads + opt + act
    if shape.kind == "prefill":
        tokens_dev = shape.tokens / chips
        act = 12.0 * tokens_dev * d * L
        kv = kv_per_tok * shape.tokens / chips
        return p_bytes + act + kv
    # decode
    kv_read = kv_per_tok * shape.seq_len * shape.global_batch / chips
    state = 0.0
    for k in cfg.block_pattern:
        if k in ("mamba", "mamba_moe"):
            state += 4 * cfg.d_inner * cfg.ssm_state_dim
        if k == "mlstm":
            state += 4 * cfg.num_heads * cfg.head_dim ** 2
        if k == "slstm":
            state += 4 * 4 * cfg.attn_dim
    state_read = 2 * state * cfg.pattern_repeats * shape.global_batch / chips
    act = 12.0 * shape.global_batch * d * L / chips
    n_active = cfg.active_param_count()
    return 2.0 * n_active / chips + kv_read + state_read + act


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs per step: 6*N_active*tokens (train),
    2*N_active*tokens (prefill), 2*N_active*batch (decode, per token) plus
    attention KV-cache reading for decode."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens
    if shape.kind == "prefill":
        # + attention score/value FLOPs: 2 * 2 * H*hd * S^2/2 * B per attn layer
        attn_layers = sum(k in ("attn", "attn_moe", "xattn")
                          for k in cfg.block_pattern) * cfg.pattern_repeats
        attn = 2.0 * cfg.attn_dim * shape.seq_len ** 2 * shape.global_batch \
            * attn_layers
        return 2.0 * n_active * shape.tokens + attn
    # decode: one token for the whole batch
    attn_layers = sum(k in ("attn", "attn_moe")
                      for k in cfg.block_pattern) * cfg.pattern_repeats
    attn = 4.0 * cfg.attn_dim * shape.seq_len * shape.global_batch * attn_layers
    return 2.0 * n_active * shape.global_batch + attn
