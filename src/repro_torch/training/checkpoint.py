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


def flatten(state) -> List[Tuple[str, Any]]:
    """(path, leaf) for every leaf of ``state``, depth first."""
    out = []

    def walk(node, path):
        kids = _children(node)
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


def save(state: Any, root: str | os.PathLike, step: int,
         keep_last: Optional[int] = None) -> pathlib.Path:
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


def _rebuild(node, leaves, device):
    """``node``'s structure with its leaves taken in order from the
    iterator ``leaves``; a module is loaded in place and returned."""
    kids = _children(node)
    if kids is None:
        arr, dtype = next(leaves)
        return _from_numpy(arr, dtype, node, device)
    vals = [_rebuild(child, leaves, device) for _, child in kids]
    if isinstance(node, nn.Module):
        node.load_state_dict({k: v for (k, _), v in zip(kids, vals)})
        return node
    if isinstance(node, dict):
        return {k: v for (k, _), v in zip(kids, vals)}
    if hasattr(node, "_fields"):
        return type(node)(*vals)
    return type(node)(vals)


def restore(template: Any, root: str | os.PathLike,
            step: Optional[int] = None, device=None,
            verify: bool = True) -> Any:
    """Restore into the structure of ``template``.

    Tensors go to ``device``, or where the template's tensor lies when it
    is None; modules in the template are loaded in place."""
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

    return _rebuild(template, load(), device)


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
    """Snapshot synchronously, write asynchronously (overlaps with compute)."""

    def __init__(self, root: str | os.PathLike, keep_last: int = 3):
        self.root = pathlib.Path(root)
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, state: Any, step: int) -> None:
        self.wait()  # one outstanding save at a time
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
