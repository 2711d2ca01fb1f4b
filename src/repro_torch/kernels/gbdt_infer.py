"""K4 and K5: batched GBDT ensemble scoring.

``gbdt_margins_cuda`` launches the hand-written Hopper kernel K4
(``csrc/gbdt_infer.cu``), which replaces the Pallas TPU kernel
``repro.kernels.gbdt_infer.gbdt_margins_kernel``: the dense complete-tree
layout, X (B, F) f32, trees (T, N) -> (B, K) margins.
``gbdt_margins_plain`` is the same function in plain PyTorch: the
level-by-level gather walk of ``ref.gbdt_margins_ref``.

``gbdt_margins_packed_cuda`` launches K5 (same source), which replaces
``gbdt_margins_packed_kernel``: the pruned (T, M) layout of
``core.ensemble_pack``, walked for exactly ``depth`` steps, plus a base
score.  ``gbdt_margins_packed_plain`` is ``ref.gbdt_margins_packed_ref``
plus the base score.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gbdt_margins_packed_ref
from repro_torch.kernels.ref import gbdt_margins_ref as gbdt_margins_plain

__all__ = ["gbdt_margins_cuda", "gbdt_margins_plain",
           "gbdt_margins_packed_cuda", "gbdt_margins_packed_plain"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
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


def gbdt_margins_packed_plain(X, feature, threshold, child, value, *,
                              depth: int, n_classes: int = 3,
                              base_score: float = 0.0):
    """Plain version of K5: the packed walk, then the base score."""
    return gbdt_margins_packed_ref(X, feature, threshold, child, value,
                                   depth=depth, n_classes=n_classes) \
        + base_score


@functools.cache
def _packed_fn():
    fn = _build.load("gbdt_infer").gbdt_margins_packed_launch
    fn.argtypes = [_P] * 6 + [_I] * 6 + [_F, _P]
    fn.restype = ctypes.c_int
    return fn


def gbdt_margins_packed_cuda(X, feature, threshold, child, value, *,
                             depth: int, n_classes: int = 3,
                             base_score: float = 0.0):
    """Launch K5 on X's device and stream.  ``feature`` must index X's
    columns (every entry < F): the kernel reads X through it unchecked."""
    B, F = X.shape
    T, M = feature.shape
    trees = (feature, threshold, child, value)
    if not (X.is_cuda and all(a.device == X.device for a in trees)):
        raise ValueError("gbdt_margins_packed_cuda needs X and the trees on "
                         "one CUDA device")
    if X.dtype != torch.float32 or feature.dtype != torch.int32 \
            or child.dtype != torch.int32 \
            or threshold.dtype != torch.float32 \
            or value.dtype != torch.float32:
        raise TypeError("X/threshold/value must be float32, feature/child "
                        "int32")
    if any(a.shape != (T, M) for a in trees) or T % n_classes \
            or F + T > _MAX_SMEM_FLOATS or depth < 0:
        raise ValueError(f"unsupported packed ensemble shape {(T, M)}, "
                         f"depth {depth}")
    if not all(a.is_contiguous() for a in (X, *trees)):
        raise ValueError("inputs must be contiguous")
    out = torch.empty((B, n_classes), dtype=torch.float32, device=X.device)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = _packed_fn()(X.data_ptr(), feature.data_ptr(), threshold.data_ptr(),
                       child.data_ptr(), value.data_ptr(), out.data_ptr(), B,
                       F, T, M, n_classes, depth, float(base_score), stream)
    _build.check(err, "gbdt_margins_packed")
    _build.LAUNCHES["gbdt_margins_packed"] += 1
    return out
