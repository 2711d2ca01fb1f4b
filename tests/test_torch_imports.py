"""The port stands alone: importing every ``repro_torch`` module and
every script of ``examples_torch/`` loads neither JAX nor any module of
the JAX package (nor ``msgpack``, which the JAX checkpoints need and the
card's machine lacks), and ``chip_smoke.py`` imports nothing of it
either.  Checked in a fresh interpreter, since this
test process has both packages loaded."""

import torch_threads  # noqa: F401  (first: caps torch threads)

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, importlib.util, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
for path in SCRIPTS:
    spec = importlib.util.spec_from_file_location("example", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro.") or m == "msgpack")
missing = sorted(set(NEW) - set(names))
print(len(names), bad, missing)
"""

#: the later slices' modules, imported by name as well: lanes and paging;
#: the sidecar, its backends and fault, routing and observability layers,
#: and the packed ensemble; the simulator, its calibration and the launch
#: CLIs; the sweep grids, the grid DES on the device and the ranking
#: metric; training (data, optimizer, train step, checkpoints, the CLI)
#: and the attention backward kernel; the config registry's package and
#: the block kinds of the pattern stack (MoE, Mamba, block dispatch); the
#: xLSTM blocks and the modality frontends; the sharding layer, meshes,
#: the roofline and dry run, elastic resume and int8 gradient exchange
NEW = ["repro_torch.sharding", "repro_torch.sharding.rules",
       "repro_torch.sharding.compat", "repro_torch.sharding.partition",
       "repro_torch.launch.mesh", "repro_torch.launch.roofline",
       "repro_torch.launch.dryrun", "repro_torch.training.elastic",
       "repro_torch.training.grad_compress",
       "repro_torch.models.xlstm", "repro_torch.models.frontends",
       "repro_torch.configs.base", "repro_torch.configs.jamba_v01_52b",
       "repro_torch.configs.xlstm_350m", "repro_torch.models.moe",
       "repro_torch.models.ssm", "repro_torch.models.transformer",
       "repro_torch.serving.batching", "repro_torch.serving.paging",
       "repro_torch.kernels.paged_decode_attention",
       "repro_torch.core.ensemble_pack", "repro_torch.core.router",
       "repro_torch.serving.faults", "repro_torch.serving.observability",
       "repro_torch.serving.metrics_http", "repro_torch.serving.backends",
       "repro_torch.serving.http_sidecar", "repro_torch.core.simulation",
       "repro_torch.core.sim_fast", "repro_torch.core._native",
       "repro_torch.core.calibration", "repro_torch.launch",
       "repro_torch.launch.serve", "repro_torch.launch.sidecar",
       "repro_torch.core.sweep", "repro_torch.core.sim_torch",
       "repro_torch.core.ranking", "repro_torch.data.lm_data",
       "repro_torch.data.pipeline", "repro_torch.training",
       "repro_torch.training.straggler", "repro_torch.training.optimizer",
       "repro_torch.training.train_loop", "repro_torch.training.checkpoint",
       "repro_torch.launch.train", "repro_torch.kernels.flash_attention_bwd"]


#: the port's example scripts
SCRIPTS = sorted(str(p) for p in (ROOT / "examples_torch").glob("*.py"))


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    assert len(SCRIPTS) == 6
    probe = f"NEW = {NEW!r}\nSCRIPTS = {SCRIPTS!r}\n" + _PROBE
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split(maxsplit=1)
    assert int(out[0]) >= 40                    # every module was imported
    assert out[1].strip() == "[] []"


def test_chip_smoke_imports_nothing_of_jax_or_repro():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module or "")
    roots = {m.split(".")[0] for m in mods}
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}


@pytest.mark.parametrize("path", SCRIPTS, ids=lambda p: Path(p).stem)
def test_example_script_imports_only_the_port(path):
    tree = ast.parse(Path(path).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}
