"""Modality frontends (stubs) and input specs: a copy of
``repro.models.frontends``.

The [vlm] and [audio] configs specify the transformer backbone only; the
modality frontend is a stub.  ``input_specs`` gives the (shape, dtype)
of every model input of a cell, ``make_batch`` a batch of seeded random
inputs in those shapes: precomputed patch embeddings (``image_embeds``)
for the vision stack, frame embeddings (``frames``) in place of tokens
for the audio one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig


class InputSpec(NamedTuple):
    """The shape and dtype of one model input (``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def batch_axes(cfg: ArchConfig, shape: ShapeConfig):
    """Logical sharding axes per batch entry (same keys as input_specs)."""
    axes = {}
    if cfg.audio_frontend:
        axes["frames"] = ("batch", "seq", "embed")
    else:
        axes["tokens"] = ("batch", "seq")
    if shape.kind == "train":
        axes["labels"] = ("batch", "seq")
    if cfg.num_image_tokens:
        axes["image_embeds"] = ("batch", "image_seq", "embed")
    return axes


def input_specs(cfg: ArchConfig, shape: ShapeConfig):
    """The (shape, dtype) of every model input of this cell.

    decode-kind shapes describe ONE new token (the cache of seq_len is a
    separate argument, ``LM.init_cache``)."""
    B = shape.global_batch
    S = shape.seq_len if shape.kind != "decode" else 1
    dt = getattr(torch, cfg.dtype)
    specs = {}
    if cfg.audio_frontend:
        specs["frames"] = InputSpec((B, S, cfg.d_model), dt)
    else:
        specs["tokens"] = InputSpec((B, S), torch.int64)
    if shape.kind == "train":
        specs["labels"] = InputSpec((B, S), torch.int64)
    if cfg.num_image_tokens:
        specs["image_embeds"] = InputSpec(
            (B, cfg.num_image_tokens, cfg.d_model), dt)
    return specs


def make_batch(cfg: ArchConfig, shape: ShapeConfig, gen: torch.Generator,
               batch_size=None, seq_len=None):
    """A batch of random inputs matching :func:`input_specs` (smoke runs),
    drawn from ``gen`` on its device: normal embeddings in the model's
    dtype, uniform token ids."""
    device = gen.device
    B = batch_size or shape.global_batch
    S = seq_len or (shape.seq_len if shape.kind != "decode" else 1)
    dt = getattr(torch, cfg.dtype)
    batch = {}
    if cfg.audio_frontend:
        batch["frames"] = torch.randn(B, S, cfg.d_model, generator=gen,
                                      device=device).to(dt)
    else:
        batch["tokens"] = torch.randint(0, cfg.vocab_size, (B, S),
                                        generator=gen, device=device)
    if shape.kind == "train":
        batch["labels"] = torch.randint(0, cfg.vocab_size, (B, S),
                                        generator=gen, device=device)
    if cfg.num_image_tokens:
        batch["image_embeds"] = torch.randn(
            B, cfg.num_image_tokens, cfg.d_model, generator=gen,
            device=device).to(dt)
    return batch
