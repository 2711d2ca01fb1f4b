"""The port's checkpoints: atomic commits, integrity digests, retention,
the async saver, restore onto the caller's device (bf16 leaves included),
and kill/restart equivalence through the port's training CLI.  CPU only;
every restored leaf must equal the saved one exactly."""

import torch_threads  # noqa: F401  (first: caps torch threads)

import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import TrainState, init_train_state


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(8, 16, generator=g),
            "h": torch.randn(4, 6, generator=g).to(torch.bfloat16),
            "blocks": ({"a": torch.arange(12.0).reshape(3, 4)},
                       {"a": torch.ones(3, 4)}),
            "step": torch.tensor(7, dtype=torch.int32),
            "host": np.arange(5, dtype=np.int64), "n": 3}


def _assert_equal(a, b):
    la, lb = ckpt.flatten(a), ckpt.flatten(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert type(x) is type(y), path
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device, path
            assert torch.equal(x, y), path
        else:
            np.testing.assert_array_equal(x, y, err_msg=path)


def test_save_restore_roundtrip_with_bf16_leaf(tmp_path):
    s = _state()
    d = ckpt.save(s, tmp_path, step=10)
    manifest = json.loads((d / ckpt.MANIFEST).read_text())
    assert manifest["dtypes"][1] == "bfloat16"
    assert np.load(d / "leaf_00001.npy").dtype == np.uint16
    _assert_equal(ckpt.restore(_state(seed=1), tmp_path), s)


def test_latest_step_and_retention(tmp_path):
    s = _state()
    for step in (1, 5, 3, 9):
        ckpt.save(s, tmp_path, step=step, keep_last=2)
    assert ckpt.latest_step(tmp_path) == 9
    assert ckpt.all_steps(tmp_path) == [5, 9]


def test_crash_mid_save_is_invisible(tmp_path):
    """A .tmp directory (a simulated crash) must never be picked up."""
    s = _state()
    ckpt.save(s, tmp_path, step=4)
    fake = tmp_path / "step_000009.tmp.deadbeef"
    fake.mkdir()
    (fake / "leaf_00000.npy").write_bytes(b"garbage")
    assert ckpt.latest_step(tmp_path) == 4
    _assert_equal(ckpt.restore(_state(seed=2), tmp_path), s)


def test_integrity_check_detects_corruption(tmp_path):
    s = _state()
    d = ckpt.save(s, tmp_path, step=2)
    leaf = d / "leaf_00000.npy"
    arr = np.load(leaf)
    arr.ravel()[0] += 1.0
    np.save(leaf, arr)
    with pytest.raises(IOError, match="integrity"):
        ckpt.restore(s, tmp_path)


def test_restore_rejects_another_structure(tmp_path):
    s = _state()
    ckpt.save(s, tmp_path, step=1)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore({"w": s["w"]}, tmp_path)
    renamed = dict(s)
    renamed["v"] = renamed.pop("w")
    with pytest.raises(ValueError, match="template"):
        ckpt.restore(renamed, tmp_path)


def test_async_checkpointer_snapshots_before_in_place_updates(tmp_path):
    s = _state()
    saver = ckpt.AsyncCheckpointer(tmp_path, keep_last=2)
    want = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in s.items()}
    for step in (1, 2, 3):
        saver.save(s, step)
        s["w"].add_(1.0)                  # the next step, in place
    saver.wait()
    assert ckpt.latest_step(tmp_path) == 3
    assert len(ckpt.all_steps(tmp_path)) == 2
    got = ckpt.restore(_state(seed=4), tmp_path, step=2)
    assert torch.equal(got["w"], want["w"] + 1.0)


def test_cpu_saved_train_state_restores_onto_callers_device(tmp_path):
    """A train state (model + AdamW state) saved on the CPU and restored
    into a fresh template on the requested device (the CPU here: the
    card's path is the same ``Tensor.to``), loading the model in place."""
    cfg = get_config("smollm-360m").reduced()
    opt = OptConfig()
    a = init_train_state(cfg, opt, device="cpu", seed=0)
    a.opt.m["embed"].fill_(0.5)
    ckpt.save(a, tmp_path, step=3)
    b = init_train_state(cfg, opt, device="cpu", seed=1)
    assert not torch.equal(a.model.embed, b.model.embed)
    model = b.model
    r = ckpt.restore(b, tmp_path, device=torch.device("cpu"))
    assert isinstance(r, TrainState) and r.model is model
    _assert_equal(r, a)
    paths = [p for p, _ in ckpt.flatten(a)]
    assert paths[0] == "model/embed" and "opt/step" in paths


def test_bf16_model_state_round_trips(tmp_path):
    import dataclasses
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              dtype="bfloat16")
    a = init_train_state(cfg, OptConfig(), device="cpu", seed=0)
    ckpt.save(a, tmp_path, step=1)
    b = ckpt.restore(init_train_state(cfg, OptConfig(), device="cpu",
                                      seed=5), tmp_path)
    assert b.model.embed.dtype == torch.bfloat16
    _assert_equal(b, a)


def test_train_resume_equivalence(tmp_path):
    """Kill/restart through the port's CLI: 6 steps straight == 3 steps +
    restart from the checkpoint + 3 steps."""
    from repro_torch.launch import train as train_mod
    args = ["--arch", "smollm-360m", "--reduced", "--batch", "4",
            "--seq", "32", "--lr", "1e-3", "--device", "cpu"]
    straight = train_mod.main(args + ["--steps", "6"])
    ck = str(tmp_path / "ck")
    train_mod.main(args + ["--steps", "3", "--ckpt", ck,
                           "--ckpt-every", "100"])
    resumed = train_mod.main(args + ["--steps", "3", "--ckpt", ck,
                                     "--ckpt-every", "100"])
    assert ckpt.latest_step(ck) == 6
    np.testing.assert_allclose(straight[3:], resumed, rtol=1e-4, atol=1e-5)
