"""What one card holds of granite-8b and dbrx-132b, the last two
registered archs it serves: granite whole and dbrx at 8 of its 40 layers
in bf16 GiB, dbrx whole and by the layer, and the train states that say
what one card can train.  Their engines are held to the JAX package's in
``test_torch_serve_archs.py``.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import dataclasses

import pytest

from repro.configs import get_config as jax_config
from repro_torch.configs import get_config
from repro_torch.launch.train import train_state_bytes

GRANITE, DBRX = "granite-8b", "dbrx-132b"
GIB = 2 ** 30


@pytest.mark.parametrize("name,layers,gib", [(GRANITE, 36, 15.38),
                                             (DBRX, 8, 50.86)])
def test_bf16_gib_the_card_is_given(name, layers, gib):
    """granite-8b whole and dbrx-132b at a fifth of its depth, each with
    room left on the card for its KV cache."""
    cfg = dataclasses.replace(get_config(name), num_layers=layers)
    jcfg = dataclasses.replace(jax_config(name), num_layers=layers)
    assert cfg.param_count() == jcfg.param_count()
    assert round(cfg.param_count() * 2 / GIB, 2) == gib
    assert cfg.param_count() * 2 / GIB < 79.0


def test_dbrx_whole_does_not_fit_the_card_and_one_layer_in_f32_does():
    dbrx = get_config(DBRX)
    assert dbrx.param_count() == 131_596_523_520
    assert round(dbrx.param_count() * 2 / GIB, 1) == 245.1
    # the embeddings and head, and one layer, in bf16
    bare = dataclasses.replace(dbrx, num_layers=0).param_count()
    one = dataclasses.replace(dbrx, num_layers=1).param_count()
    assert round(bare * 2 / GIB, 2) == 2.30
    assert round((one - bare) * 2 / GIB, 2) == 6.07
    # the card's kernels-vs-plain hold: one layer in float32
    assert round(one * 4 / GIB, 1) == 16.7


@pytest.mark.parametrize("name,gib,fits", [("gemma-2b", 28.01, True),
                                           (GRANITE, 92.25, False),
                                           (DBRX, 1470.7, False)])
def test_train_state_says_what_one_card_trains(name, gib, fits):
    """The bf16 weights, their gradients and AdamW's two float32 moments
    (activations not counted): gemma-2b's fit the card's 80 GB, granite's
    and dbrx's do not (multi-card work)."""
    got = train_state_bytes(get_config(name))
    assert round(got / GIB, 2 if gib < 100 else 1) == gib
    assert (got < 80e9) == fits
