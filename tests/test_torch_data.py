"""The port's data modules against the JAX package's: the synthetic LM
token stream (bit for bit, per host shard and step), the prefetch
loader's order, and the Table 3 splits and held-out sets (the same
arrays).  All numpy on the CPU: exact equality throughout."""

import torch_threads  # noqa: F401  (first: caps torch threads)

import numpy as np
import pytest

from repro.data import lm_data as jlm_data
from repro.data import pipeline as jpipeline
from repro_torch.data.corpus import sample_dataset
from repro_torch.data.lm_data import (LMDataConfig, PrefetchLoader,
                                      SyntheticLMStream)
from repro_torch.data.pipeline import (MODEL_SPLITS, heldout_eval_set,
                                       load_model_splits, stratified_split)


@pytest.mark.parametrize("host_index,host_count", [(0, 1), (0, 2), (1, 2),
                                                   (3, 4)])
@pytest.mark.parametrize("step", [0, 7, 12345])
def test_lm_stream_equals_jax(host_index, host_count, step):
    kw = dict(vocab_size=49152, seq_len=33, global_batch=8, seed=3,
              branching=5)
    mine = SyntheticLMStream(LMDataConfig(**kw), host_index, host_count)
    theirs = jlm_data.SyntheticLMStream(jlm_data.LMDataConfig(**kw),
                                        host_index, host_count)
    a, b = mine.batch(step), theirs.batch(step)
    for key in ("tokens", "labels"):
        assert a[key].dtype == b[key].dtype == np.int32
        np.testing.assert_array_equal(a[key], b[key])


def test_lm_stream_sharding_and_shift():
    cfg = LMDataConfig(vocab_size=128, seq_len=16, global_batch=8)
    full = SyntheticLMStream(cfg, 0, 1).batch(7)
    h0 = SyntheticLMStream(cfg, 0, 2).batch(7)
    h1 = SyntheticLMStream(cfg, 1, 2).batch(7)
    np.testing.assert_array_equal(
        np.concatenate([h0["tokens"], h1["tokens"]]), full["tokens"])
    np.testing.assert_array_equal(full["labels"][:, :-1],
                                  full["tokens"][:, 1:])


def test_lm_stream_iterates_in_step_order():
    stream = SyntheticLMStream(LMDataConfig(vocab_size=64, seq_len=8,
                                            global_batch=4))
    it = iter(stream)
    for step in range(3):
        np.testing.assert_array_equal(next(it)["tokens"],
                                      stream.batch(step)["tokens"])


def test_prefetch_loader_order_and_batches():
    cfg = LMDataConfig(vocab_size=64, seq_len=8, global_batch=4)
    stream = SyntheticLMStream(cfg)
    loader = PrefetchLoader(stream, start_step=3)
    it = iter(loader)
    got = [next(it) for _ in range(4)]
    loader.close()
    assert [s for s, _ in got] == [3, 4, 5, 6]
    for s, b in got:
        np.testing.assert_array_equal(b["tokens"], stream.batch(s)["tokens"])


@pytest.mark.parametrize("model", sorted(MODEL_SPLITS))
def test_table3_splits_equal_jax(model):
    mine, theirs = load_model_splits(model), jpipeline.load_model_splits(model)
    spec = MODEL_SPLITS[model]
    assert MODEL_SPLITS == jpipeline.MODEL_SPLITS
    for part in ("train", "val", "test"):
        a, b = getattr(mine, part), getattr(theirs, part)
        assert len(a) == 3 * spec[part]
        np.testing.assert_array_equal(a.X, b.X)
        np.testing.assert_array_equal(a.y, b.y)
        np.testing.assert_array_equal(a.lengths, b.lengths)
        assert a.prompts == b.prompts
        counts = np.bincount(a.y, minlength=3)
        assert counts.min() == counts.max()


def test_split_raises_on_starved_class():
    ds = sample_dataset("alpaca", n=30000, seed=0)
    with pytest.raises(ValueError, match="starvation"):
        stratified_split(ds, {"train": 1600, "val": 200, "test": 200})


@pytest.mark.parametrize("dataset", ["lmsys", "oasst1"])
def test_heldout_eval_set_equals_jax(dataset):
    a = heldout_eval_set(dataset, n=300, seed=5)
    b = jpipeline.heldout_eval_set(dataset, n=300, seed=5)
    np.testing.assert_array_equal(a.X, b.X)
    np.testing.assert_array_equal(a.y, b.y)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    assert a.prompts == b.prompts
