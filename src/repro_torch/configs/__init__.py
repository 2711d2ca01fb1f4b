"""Config registry (a copy of ``repro.configs``): ``get_config(arch_id)``
resolves every architecture the JAX package registers, eleven in all.

Arch ids use the assignment spelling (e.g. ``llama4-maverick-400b-a17b``);
module names use underscores.  Every config resolves, for the launch CLIs'
service-time model (``ServiceTimeModel.from_arch``) and the KV accounting.
The port's ``LM`` builds all eleven: smollm-360m, gemma3-4b-edge,
gemma-2b, granite-8b, qwen3-32b (QK-norm), dbrx-132b and llama4-maverick
(MoE), jamba-v0.1-52b (Mamba + MoE + attention), xlstm-350m (sLSTM +
mLSTM), llama-3.2-vision-90b (cross-attention over image embeddings
every fifth layer) and musicgen-large (the audio frontend: frame
embeddings in, no embedding table).

Two configs the engines serve at full width on the card:

* ``smollm-360m`` (HuggingFaceTB/SmolLM-360M ``config.json``: 32 layers,
  d_model 960, 15 query heads over 5 KV heads of width 64, SwiGLU d_ff
  2560, vocab 49152, tied embeddings, RoPE theta 1e4), the engines' and
  the sidecar's default;
* ``gemma3-4b-edge`` (Gemma3-4b's text stack, the paper's own backend: 34
  layers, d_model 2560, 8 query heads over 4 KV heads of width 256, GeGLU
  d_ff 10240, vocab 262144, tied embeddings, RoPE theta 1e6).  As in the
  reference, it has no embedding scale, no QK-norm, no softcap and no
  sliding window.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPE_NAMES, SHAPES, ArchConfig, ShapeConfig

_ARCH_MODULES = {
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "dbrx-132b": "dbrx_132b",
    "xlstm-350m": "xlstm_350m",
    "granite-8b": "granite_8b",
    "smollm-360m": "smollm_360m",
    "gemma-2b": "gemma_2b",
    "qwen3-32b": "qwen3_32b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "musicgen-large": "musicgen_large",
    # The paper's own serving backend (not part of the assigned matrix).
    "gemma3-4b-edge": "gemma3_4b_edge",
}

# The ten assigned architectures (dry-run matrix rows).
ARCH_NAMES = tuple(n for n in _ARCH_MODULES if n != "gemma3-4b-edge")
ALL_ARCH_NAMES = tuple(_ARCH_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def matrix_cells(include_skips: bool = False):
    """Yield (arch, shape) cells of the 10x4 assignment matrix.

    With ``include_skips=False`` (default) the 8 structural long_500k skips for
    pure full-attention archs are omitted (32 runnable cells).
    """
    for arch_name in ARCH_NAMES:
        cfg = get_config(arch_name)
        for shape_name in SHAPE_NAMES:
            if include_skips or cfg.supports_shape(shape_name):
                yield arch_name, shape_name


SMOLLM_360M = get_config("smollm-360m")
GEMMA3_4B_EDGE = get_config("gemma3-4b-edge")

__all__ = [
    "ArchConfig",
    "ShapeConfig",
    "SHAPES",
    "SHAPE_NAMES",
    "ARCH_NAMES",
    "ALL_ARCH_NAMES",
    "GEMMA3_4B_EDGE",
    "SMOLLM_360M",
    "get_config",
    "get_shape",
    "matrix_cells",
]
