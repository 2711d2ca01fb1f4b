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

Both kernels split the trees over a thread-block cluster of
:func:`tree_split_plan` blocks, each taking the range
:func:`tree_ranges` gives it, and sum the leaf values in the order
:func:`tree_fold` states.  The plan depends on (T, K) alone, so a row's
margins do not depend on the batch it is scored in, and K5's margins
equal K4's plus the base score bit for bit.
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
           "gbdt_margins_packed_cuda", "gbdt_margins_packed_plain",
           "tree_split_plan", "tree_ranges", "tree_fold"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: the portable thread-block-cluster size of Hopper (kMaxSlices in
#: csrc/gbdt_infer.cu)
MAX_SLICES = 8
#: trees per block the plan aims at: fewer slices below 8 * 24 trees
SLICE_TREES = 24
#: shared memory a block may use (kSmemBytes), in floats
_MAX_SMEM_FLOATS = 227 * 1024 // 4


def tree_split_plan(T: int, K: int) -> int:
    """Blocks of the cluster the T trees (K classes) are split over: one
    per ``SLICE_TREES`` trees, at least 1, at most ``MAX_SLICES`` and at
    most T / K (every slice holds a whole group of K trees).  It depends
    on (T, K) alone, never on the batch."""
    return max(1, min(MAX_SLICES, T // K, -(-T // SLICE_TREES)))


def tree_ranges(T: int, K: int) -> torch.Tensor:
    """The tree range ``[lo, hi)`` of each block: (tree_split_plan(T, K),
    2) int64.  With G = T / K groups of K trees, block r takes
    ``lo = (r * G // n) * K`` to ``hi = ((r + 1) * G // n) * K``: ranges
    in order, each a whole number of groups, so tree ``lo + j`` has class
    ``j % K``; their sizes differ by at most one group."""
    n, G = tree_split_plan(T, K), T // K
    edges = torch.arange(n + 1, dtype=torch.int64) * G // n * K
    return torch.stack([edges[:-1], edges[1:]], dim=1)


def _fold_width(T: int, K: int) -> int:
    """Lanes that fold one (row, class) of a slice: the groups of the
    largest slice rounded up to a power of two, at most a warp."""
    groups = -(-(T // K) // tree_split_plan(T, K))
    w = 1
    while w < min(groups, 32):
        w *= 2
    return w


def tree_fold(leaves: torch.Tensor, n_classes: int) -> torch.Tensor:
    """The kernels' class sums in plain PyTorch, float add for float add:
    ``leaves`` (T, B) f32 (the leaf value each tree gives each row) ->
    (B, n_classes).  Per slice of :func:`tree_ranges` and class, the
    slice's groups are cut into chunks of ``w`` (zero-padded); each chunk
    is a butterfly (offsets w/2 .. 1, every lane adding its partner's
    value to its own) and the chunks add in order; the slices' partials
    add in rank order.  K5 adds its base score to the result."""
    T, B = leaves.shape
    K, w = n_classes, _fold_width(T, n_classes)
    lanes = torch.arange(w, device=leaves.device)
    total = None
    for lo, hi in tree_ranges(T, K).tolist():
        g = (hi - lo) // K
        v = leaves[lo:hi].reshape(g, K, B)
        v = torch.cat([v, v.new_zeros(-g % w, K, B)]).reshape(-1, w, K, B)
        off = w // 2
        while off:
            v = v + v[:, lanes ^ off]
            off //= 2
        part = v[0, 0]
        for chunk in v[1:, 0]:
            part = part + chunk
        total = part if total is None else total + part
    return total.T.contiguous()


def _check_fits(F: int, T: int, K: int) -> None:
    """Raise unless one row's features, leaf values and partials fit a
    block's shared memory (the kernel stages or streams the trees)."""
    n = tree_split_plan(T, K)
    slice_trees = -(-(T // K) // n) * K
    if 4 + F + slice_trees + n * K > _MAX_SMEM_FLOATS:
        raise ValueError(f"unsupported ensemble: {T} trees of {K} classes "
                         f"over {F} features")


@functools.cache
def _fn():
    fn = _build.load("gbdt_infer").gbdt_margins_launch
    fn.argtypes = [_P] * 5 + [_I] * 7 + [_P]
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
            or T % n_classes:
        raise ValueError(f"unsupported ensemble shape {(T, N)}")
    _check_fits(F, T, n_classes)
    if not all(a.is_contiguous() for a in (X, feature, threshold, value)):
        raise ValueError("inputs must be contiguous")
    out = torch.empty((B, n_classes), dtype=torch.float32, device=X.device)
    if B == 0:
        return out
    depth = int(math.log2(N + 1)) - 1
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = _fn()(X.data_ptr(), feature.data_ptr(), threshold.data_ptr(),
                value.data_ptr(), out.data_ptr(), B, F, T, N, n_classes,
                depth, tree_split_plan(T, n_classes), stream)
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
    fn.argtypes = [_P] * 6 + [_I] * 7 + [_F, _P]
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
            or depth < 0:
        raise ValueError(f"unsupported packed ensemble shape {(T, M)}, "
                         f"depth {depth}")
    _check_fits(F, T, n_classes)
    if not all(a.is_contiguous() for a in (X, *trees)):
        raise ValueError("inputs must be contiguous")
    out = torch.empty((B, n_classes), dtype=torch.float32, device=X.device)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = _packed_fn()(X.data_ptr(), feature.data_ptr(), threshold.data_ptr(),
                       child.data_ptr(), value.data_ptr(), out.data_ptr(), B,
                       F, T, M, n_classes, depth,
                       tree_split_plan(T, n_classes), float(base_score),
                       stream)
    _build.check(err, "gbdt_margins_packed")
    _build.LAUNCHES["gbdt_margins_packed"] += 1
    return out
