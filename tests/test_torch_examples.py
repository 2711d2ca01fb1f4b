"""The port's example scripts (``examples_torch/``) held to the JAX
package's (``examples/``), script for script, on the CPU:

* ``quickstart.py`` and ``multireplica_routing.py`` print the JAX
  scripts' output line for line (the predictor's trees are the same, its
  scores through K5's plain version within 1e-5 of the JAX host
  scorer's, so every printed figure agrees);
* ``serve_sidecar.py --http`` with a small burst loses no request and
  SJF's short P50 over the wire is below FCFS's;
* ``train_lm.py`` (reduced smollm, 30 steps): finite losses that fall,
  and the checkpoint written;
* without a card and without ``--device``, every script raises before
  it does any work.

The serving scripts (lanes, speculative lanes, the in-process sidecar)
are held to JAX on carried weights in tests/test_torch_examples_serve.py.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import importlib.util
import math
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ("quickstart", "multireplica_routing", "batched_serve",
           "speculative_serve", "serve_sidecar", "train_lm")


def load(package: str, name: str):
    """``examples/<name>.py`` (``package`` "jax") or
    ``examples_torch/<name>.py`` ("port") as a module."""
    folder = "examples" if package == "jax" else "examples_torch"
    spec = importlib.util.spec_from_file_location(
        f"{package}_example_{name}", ROOT / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["quickstart", "multireplica_routing"])
def test_script_prints_the_jax_scripts_lines(name, capsys):
    load("jax", name).main()
    want = capsys.readouterr().out.splitlines()
    load("port", name).main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(want) >= 5
    assert got == want


def test_sidecar_over_http_loses_nothing_and_sjf_wins(capsys):
    out = load("port", "serve_sidecar").main(
        ["--http", "--requests", "24", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "firing 24 streaming requests" in printed
    p50 = out["short_p50"]
    assert p50["sjf"] < p50["fcfs"], p50


def test_train_lm_loss_falls_and_checkpoints(tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    losses = load("port", "train_lm").main(
        ["--steps", "30", "--ckpt", str(ckpt), "--device", "cpu"])
    assert len(losses) == 30 and all(map(math.isfinite, losses))
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])
    assert (ckpt / "step_000030").is_dir()
    assert f"over 30 steps; checkpoints in {ckpt}" in capsys.readouterr().out


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_without_a_card_or_device_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load("port", name).main([])
