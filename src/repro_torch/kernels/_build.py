"""Build the hand-written Hopper kernels with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C launcher and is compiled on
first use into its own shared library under ``build/repro_torch/`` at the
repository root (listed in ``.gitignore``), then loaded with ``ctypes``.
The library's file name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and an
unchanged one is reused.  No PyTorch
header is compiled: a build takes seconds, not minutes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("decode_attention", "paged_decode_attention", "flash_attention",
           "flash_attention_bwd", "gbdt_infer")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: launches per kernel: each launcher adds one where it launches its
#: kernel, and nowhere else (a run reads these to show which kernels the
#: path went through)
LAUNCHES: Dict[str, int] = {"decode_attention": 0,
                            "paged_decode_attention": 0,
                            "flash_attention": 0, "flash_attention_bwd": 0,
                            "gbdt_margins": 0, "gbdt_margins_packed": 0}
#: ``-Xptxas -v`` report (registers, shared memory, spills) per kernel build
PTXAS_REPORT: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{tag}.so"


def _start(name: str):
    """Start one nvcc for ``name`` unless its library exists; returns
    (final path, temporary path, process) or (path, None, None)."""
    out = _lib_path(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together.  Returns wall seconds per kernel (0.0
    for a library that was already built).  Raises on a failed build."""
    t0 = time.monotonic()
    jobs = {n: _start(n) for n in names}
    secs: Dict[str, float] = {}
    errors = []
    for name, (out, tmp, proc) in jobs.items():
        if proc is None:
            secs[name] = 0.0
            continue
        log, _ = proc.communicate()
        secs[name] = time.monotonic() - t0
        PTXAS_REPORT[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, building it if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
    return lib


def rows_aligned(x, nbytes: int = 16) -> bool:
    """True when every row of ``x`` along its last (contiguous) axis
    starts on an ``nbytes`` boundary: the kernels load rows in 16-byte
    vectors.  The stride of an axis of length 1 is never used."""
    esize = x.element_size()
    return x.data_ptr() % nbytes == 0 and all(
        st * esize % nbytes == 0
        for st, n in zip(x.stride()[:-1], x.shape[:-1]) if n > 1)


def check(err: int, name: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
