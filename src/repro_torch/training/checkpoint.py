"""Checkpointing with atomic commits and integrity checks (port of
``repro.training.checkpoint`` on one device).

Layout (one directory per step):

    ckpt_root/
      step_000420.tmp.<nonce>/   # written here first
      step_000420/               # atomic rename after fsync
        manifest.json            # leaf names, shapes, dtypes, crc32 digests
        leaf_00000.npy ...       # one file per leaf

The guarantees are the JAX package's: a crash mid-save never corrupts the
latest checkpoint (``latest_step`` only believes committed directories);
every leaf's crc32 is checked on restore; ``AsyncCheckpointer`` snapshots
to host memory synchronously and writes in a background thread; and
``keep_last`` bounds retention.  ``restore`` places the tensors on the
caller's device.

Two deliberate differences: the manifest is JSON, not msgpack (the port
needs no package beyond numpy for it), and numpy has no bfloat16, so a
bf16 leaf is stored as its ``uint16`` bit pattern and its dtype is
recorded.  A port checkpoint is not meant to be read by the JAX package,
nor the other way round.

A state is any nesting of dicts, lists, tuples (named tuples included),
``nn.Module``s (their state dicts) and leaves: tensors, numpy arrays and
Python numbers.  Restoring into a module loads the checkpoint into that
module in place.

On a mesh (``training.train_loop.make_train_step(mesh=)``) a leaf whose
spec shards it over the ``data`` or the ``model`` axis is held as this
rank's block.  ``save(mesh=, specs=)`` all-gathers those leaves (every
rank calls it) and rank 0 alone writes, so the files are the full
tensors in the single-device format.  ``restore(mesh=, axes=)`` reads
the full leaves and lays each out by the spec its logical axes resolve
to on the mesh (the reshard: any mesh can resume any checkpoint, a
(2, 2) state at (1, 1), (4, 1) or (1, 2)).
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
import uuid
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

MANIFEST = "manifest.json"


def _leaf_name(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of a container, or None for a leaf."""
    if isinstance(node, nn.Module):
        return list(node.state_dict().items())
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def flatten(state, is_leaf=None) -> List[Tuple[str, Any]]:
    """(path, leaf) for every leaf of ``state``, depth first.  ``is_leaf``
    stops the walk at nodes it accepts (``sharding.rules.is_axes_leaf``
    for an axes tree)."""
    out = []

    def walk(node, path):
        kids = None if is_leaf is not None and is_leaf(node) \
            else _children(node)
        if kids is None:
            out.append((path, node))
            return
        for key, child in kids:
            walk(child, f"{path}/{key}" if path else str(key))

    walk(state, "")
    return out


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array to write, dtype name to record)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).split(".")[1]
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str, template, device):
    """A leaf like ``template`` from the stored array: a tensor on
    ``device`` (default: the template's), a numpy array or a number."""
    if isinstance(template, torch.Tensor):
        if dtype == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(arr.copy())
        return t.to(device if device is not None else template.device)
    if isinstance(template, np.ndarray):
        return arr
    return arr.item()


def _gathered(state, mesh, specs) -> Optional[dict]:
    """{path: full leaf} of a state held in shards on ``mesh`` (every
    rank calls this; ``specs`` has every path), on rank 0; None on the
    others."""
    import torch.distributed as dist
    from repro_torch.sharding.partition import gather_tree
    full = gather_tree(dict(flatten(state)), specs, mesh)
    return full if dist.get_rank() == 0 else None


def _sharded(mesh) -> bool:
    from repro_torch.sharding import mesh_size
    return mesh is not None and mesh_size(mesh) > 1


def save(state: Any, root: str | os.PathLike, step: int,
         keep_last: Optional[int] = None, *, mesh=None,
         specs: Optional[dict] = None) -> Optional[pathlib.Path]:
    """Write ``state`` as step ``step``.  With ``mesh`` (of more than one
    device) and ``specs`` ({path: PartitionSpec} of every leaf,
    ``train_loop.state_specs``), the sharded leaves are gathered first
    and only rank 0 writes (the others return None)."""
    if _sharded(mesh):
        state = _gathered(state, mesh, specs)
        if state is None:
            return None
    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:06d}"
    tmp = root / f"step_{step:06d}.tmp.{uuid.uuid4().hex[:8]}"
    tmp.mkdir(parents=True)

    leaves = flatten(state)
    paths, shapes, dtypes, digests = [], [], [], []
    for i, (path, leaf) in enumerate(leaves):
        arr, dtype = _to_numpy(leaf)
        with open(tmp / _leaf_name(i), "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        paths.append(path)
        shapes.append(list(arr.shape))
        dtypes.append(dtype)
        digests.append(zlib.crc32(arr.tobytes()))

    manifest = {"step": step, "paths": paths, "num_leaves": len(leaves),
                "shapes": shapes, "dtypes": dtypes, "digests": digests,
                "time": time.time()}
    with open(tmp / MANIFEST, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())

    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit

    if keep_last:
        steps = sorted(all_steps(root))
        for s in steps[:-keep_last]:
            shutil.rmtree(root / f"step_{s:06d}", ignore_errors=True)
    return final


def all_steps(root: str | os.PathLike) -> list[int]:
    root = pathlib.Path(root)
    out = []
    for d in root.glob("step_*"):
        if d.is_dir() and ".tmp." not in d.name and (d / MANIFEST).exists():
            out.append(int(d.name.split("_")[1]))
    return sorted(out)


def latest_step(root: str | os.PathLike) -> Optional[int]:
    steps = all_steps(root)
    return steps[-1] if steps else None


def _load_module(module: nn.Module, sd: dict) -> None:
    """Load ``sd`` into ``module`` in place; a parameter whose stored
    tensor has another shape (a shard on a mesh) takes it as its data."""
    params = dict(module.named_parameters())
    if all(params[k].shape == v.shape for k, v in sd.items() if k in params):
        module.load_state_dict(sd)
        return
    for k, v in sd.items():
        params[k].data = v


def _rebuild(node, leaves, device, layout=None, path=""):
    """``node``'s structure with its leaves taken in order from the
    iterator ``leaves``; a module is loaded in place and returned.
    ``layout(path, tensor)`` cuts each tensor leaf to its shard."""
    kids = _children(node)
    if kids is None:
        arr, dtype = next(leaves)
        leaf = _from_numpy(arr, dtype, node, device)
        return layout(path, leaf) if layout is not None and \
            isinstance(leaf, torch.Tensor) else leaf
    vals = [_rebuild(child, leaves, device, layout,
                     f"{path}/{k}" if path else str(k)) for k, child in kids]
    if isinstance(node, nn.Module):
        _load_module(node, {k: v for (k, _), v in zip(kids, vals)})
        return node
    if isinstance(node, dict):
        return {k: v for (k, _), v in zip(kids, vals)}
    if hasattr(node, "_fields"):
        return type(node)(*vals)
    return type(node)(vals)


def restore(template: Any, root: str | os.PathLike,
            step: Optional[int] = None, device=None,
            verify: bool = True, *, mesh=None, axes: Any = None) -> Any:
    """Restore into the structure of ``template``.

    Tensors go to ``device``, or where the template's tensor lies when it
    is None; modules in the template are loaded in place.  With ``mesh``
    and ``axes`` (the template's logical-axes tree, e.g. from
    ``abstract_train_state``), each leaf becomes this rank's shard of the
    spec its axes resolve to at the stored full shape."""
    root = pathlib.Path(root)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = root / f"step_{step:06d}"
    manifest = json.loads((d / MANIFEST).read_text())

    paths = [p for p, _ in flatten(template)]
    if manifest["num_leaves"] != len(paths):
        raise ValueError(
            f"checkpoint has {manifest['num_leaves']} leaves; "
            f"template has {len(paths)}")
    if manifest["paths"] != paths:
        raise ValueError("checkpoint leaves are not the template's")

    def load():
        for i in range(manifest["num_leaves"]):
            arr = np.load(d / _leaf_name(i))
            if verify and zlib.crc32(arr.tobytes()) != manifest["digests"][i]:
                raise IOError(f"checkpoint leaf {i} failed integrity check")
            yield arr, manifest["dtypes"][i]

    layout = None
    if mesh is not None:
        from repro_torch.sharding.partition import local_shard
        from repro_torch.sharding.rules import is_axes_leaf, spec_for
        leaf_axes = dict(flatten(axes, is_leaf=is_axes_leaf))

        def layout(path, t):
            return local_shard(t, spec_for(t.shape, leaf_axes[path], mesh),
                               mesh)
    return _rebuild(template, load(), device, layout)


def _host_copy(node):
    """A host snapshot of ``node``: every tensor copied to the CPU (a
    copy, never a view of a tensor the next step updates in place)."""
    kids = _children(node)
    if kids is None:
        if isinstance(node, torch.Tensor):
            return node.detach().to("cpu", copy=True)
        return np.array(node, copy=True) if isinstance(node, np.ndarray) \
            else node
    vals = [_host_copy(child) for _, child in kids]
    if isinstance(node, (nn.Module, dict)):
        return {k: v for (k, _), v in zip(kids, vals)}
    if hasattr(node, "_fields"):
        return type(node)(*vals)
    return type(node)(vals)


class AsyncCheckpointer:
    """Snapshot synchronously, write asynchronously (overlaps with compute).
    On a mesh every rank calls ``save``: the sharded leaves are gathered
    synchronously and rank 0 alone writes."""

    def __init__(self, root: str | os.PathLike, keep_last: int = 3, *,
                 mesh=None, specs: Optional[dict] = None):
        self.root = pathlib.Path(root)
        self.keep_last = keep_last
        self.mesh, self.specs = mesh, specs
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, state: Any, step: int) -> None:
        self.wait()  # one outstanding save at a time
        if _sharded(self.mesh):
            state = _gathered(state, self.mesh, self.specs)
            if state is None:
                return
        host_state = _host_copy(state)

        def _run():
            try:
                save(host_state, self.root, step, keep_last=self.keep_last)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
