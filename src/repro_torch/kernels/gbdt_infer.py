"""K4: batched GBDT ensemble scoring (dense complete-tree layout).

``gbdt_margins_cuda`` launches the hand-written Hopper kernel
(``csrc/gbdt_infer.cu``), which replaces the Pallas TPU kernel
``repro.kernels.gbdt_infer.gbdt_margins_kernel``.  ``gbdt_margins_plain``
is the same function in plain PyTorch: the level-by-level gather walk of
``ref.gbdt_margins_ref``.  X (B, F) f32, trees (T, N) -> (B, K) margins.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gbdt_margins_ref as gbdt_margins_plain

__all__ = ["gbdt_margins_cuda", "gbdt_margins_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_MAX_SMEM_FLOATS = 227 * 1024 // 4


@functools.cache
def _fn():
    fn = _build.load("gbdt_infer").gbdt_margins_launch
    fn.argtypes = [_P] * 5 + [_I] * 6 + [_P]
    fn.restype = ctypes.c_int
    return fn


def gbdt_margins_cuda(X, feature, threshold, value, *, n_classes: int = 3):
    """Launch K4 on X's device and stream."""
    B, F = X.shape
    T, N = feature.shape
    if not (X.is_cuda and all(a.device == X.device
                              for a in (feature, threshold, value))):
        raise ValueError("gbdt_margins_cuda needs X and the trees on one "
                         "CUDA device")
    if X.dtype != torch.float32 or feature.dtype != torch.int32 \
            or threshold.dtype != torch.float32 \
            or value.dtype != torch.float32:
        raise TypeError("X/threshold/value must be float32, feature int32")
    if threshold.shape != (T, N) or value.shape != (T, N) \
            or T % n_classes or F + T > _MAX_SMEM_FLOATS:
        raise ValueError(f"unsupported ensemble shape {(T, N)}")
    if not all(a.is_contiguous() for a in (X, feature, threshold, value)):
        raise ValueError("inputs must be contiguous")
    out = torch.empty((B, n_classes), dtype=torch.float32, device=X.device)
    if B == 0:
        return out
    depth = int(math.log2(N + 1)) - 1
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = _fn()(X.data_ptr(), feature.data_ptr(), threshold.data_ptr(),
                value.data_ptr(), out.data_ptr(), B, F, T, N, n_classes,
                depth, stream)
    _build.check(err, "gbdt_margins")
    _build.LAUNCHES["gbdt_margins"] += 1
    return out
