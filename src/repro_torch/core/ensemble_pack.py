"""Pruned export of a trained GBDT ensemble (port of
``repro.core.ensemble_pack``).

``GBDTModel`` stores complete binary trees: ``2**(max_depth+1) - 1`` dense
slots per tree, most of them dead ``-1`` padding for real models.
:func:`pack_ensemble` (an exact copy of the JAX package's) repacks a
trained ensemble into two layouts, array for array the JAX pack's:

* **Flat SoA.**  Live nodes of all trees concatenated in per-tree BFS
  order with sibling pairs adjacent, so one int32 ``child`` array encodes
  both children (left at ``child``, right at ``child + 1``).  Leaves are
  self-loops with an unsatisfiable threshold; thresholds are quantized to
  per-feature bin ids (``thr_bin``) over the edge tables ``bin_edges``.
  ``bin_input`` bins inputs against these tables, as in the JAX pack.
  The JAX package scores this layout on the host (a C loop and a numpy
  traversal); the port scores the padded layout below instead.
* **Padded per-tree SoA.**  The same pruned trees padded to the max live
  node count M as ``(T, M)`` tensors ``pfeat``/``pthr``/``pchild``/
  ``pvalue`` with float thresholds (leaves: ``+inf``) and in-tree child
  indices, walked for exactly ``depth`` steps.  This is the layout K5
  scores (``kernels.ops.gbdt_margins_packed``): the hand-written kernel on
  the card, its plain PyTorch version on the CPU.  The float compare
  ``go_right = ~(x < thr)`` matches the dense traversal for every finite
  input; a NaN feature would escape a leaf self-loop, so the path assumes
  finite features (the 19 Clairvoyant features always are).

``predict_margin`` / ``predict_proba`` / ``predict_p_long`` score through
K5 on the card unless the caller names a device (``device='cpu'`` for
the plain version on the host); they raise when no card is present and
none is named.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models.model import resolve_device

_LEAF_BIN = np.uint16(0xFFFF)   # > any input bin (edge tables cap at 0xFFFE)


@dataclass
class PackedEnsemble:
    # flat SoA over all live nodes
    feat: np.ndarray        # (total,) int32  feature index (0 at leaves)
    thr_bin: np.ndarray     # (total,) uint16 go right iff xbin >= thr_bin
    child: np.ndarray       # (total,) int32  absolute left child; leaf: self
    value: np.ndarray       # (total,) float32
    roots: np.ndarray       # (T,) int32
    # padded per-tree SoA (K5 and its plain version)
    pfeat: np.ndarray       # (T, M) int32
    pthr: np.ndarray        # (T, M) float32, +inf at leaves
    pchild: np.ndarray      # (T, M) int32, in-tree left child; leaf: self
    pvalue: np.ndarray      # (T, M) float32
    bin_edges: List[np.ndarray]   # per feature, sorted float32 thresholds
    n_classes: int
    n_features: int
    depth: int              # max live depth over all trees
    base_score: float = 0.0
    _tensors: dict = field(default_factory=dict, repr=False, compare=False)
    _setup: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def num_trees(self) -> int:
        return self.roots.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.feat.shape[0]

    def tensors(self, device) -> tuple:
        """(pfeat, pthr, pchild, pvalue) on ``device``, copied once."""
        device = torch.device(device)
        if device not in self._tensors:
            self._tensors[device] = tuple(
                torch.as_tensor(np.ascontiguousarray(a), device=device)
                for a in (self.pfeat, self.pthr, self.pchild, self.pvalue))
        return self._tensors[device]

    def _edges_matrix(self) -> np.ndarray:
        """(F, Emax) NaN-padded per-feature edge tables (cached)."""
        mat = self._setup.get("edges_mat")
        if mat is None:
            emax = max([e.size for e in self.bin_edges] + [1])
            mat = np.full((self.n_features, emax), np.nan, np.float32)
            for f, e in enumerate(self.bin_edges):
                mat[f, :e.size] = e
            self._setup["edges_mat"] = mat
        return mat

    def bin_input(self, X: np.ndarray) -> np.ndarray:
        """(B, n_features) uint16 bin ids.

        Small batches (the serial serving path — B=1 per admission) use
        one broadcast compare against the cached NaN-padded edge matrix:
        ``sum(edges <= x)`` equals ``searchsorted(..., side="right")`` for
        every finite input and costs 3 numpy calls instead of one
        searchsorted per feature.  Large batches keep the per-feature
        searchsorted (linear in edges beats log only while B*Emax is
        small); non-finite inputs also take that path (NaN must sort past
        the last edge, as in the dense traversal).
        """
        X = np.asarray(X, np.float32)
        B = X.shape[0]
        if 0 < B <= 32 and np.isfinite(X).all():
            mat = self._edges_matrix()
            return (mat[None] <= X[:, :, None]).sum(axis=2).astype(np.uint16)
        out = np.empty((B, self.n_features), np.uint16)
        for f in range(self.n_features):
            edges = self.bin_edges[f]
            if edges.size:
                out[:, f] = np.searchsorted(edges, X[:, f], side="right")
            else:
                out[:, f] = 0
        return out

    def predict_margin(self, X: np.ndarray, device=None) -> np.ndarray:
        """(B, n_classes) raw margins, base score included, scored on
        ``device`` through the padded layout (K5 on the card)."""
        device = resolve_device(device)
        X = np.asarray(X, np.float32)
        if X.shape[0] == 0:
            return np.zeros((0, self.n_classes), np.float32)
        x = torch.as_tensor(X, device=device).contiguous()
        return ops.gbdt_margins_packed_from(self, x).cpu().numpy()

    def predict_proba(self, X: np.ndarray, device=None) -> np.ndarray:
        """Softmax of :meth:`predict_margin` (same device rule)."""
        from repro_torch.core.gbdt import _softmax
        return _softmax(self.predict_margin(X, device))

    def predict_p_long(self, X: np.ndarray, long_class: int = 2,
                       device=None) -> np.ndarray:
        """The scheduler's priority key (same device rule)."""
        return self.predict_proba(X, device)[:, long_class]


def pack_ensemble(model) -> PackedEnsemble:
    """Prune a dense ``GBDTModel`` into a :class:`PackedEnsemble`."""
    feats = np.asarray(model.feature)
    thrs = np.asarray(model.threshold, np.float32)
    vals = np.asarray(model.value, np.float32)
    T, N = feats.shape

    n_features = int(max(feats.max(), 0)) + 1
    # per-feature edge tables from the thresholds the ensemble actually uses
    bin_edges = []
    for f in range(n_features):
        used = thrs[feats == f]
        edges = np.unique(used.astype(np.float32))
        assert edges.size <= 0xFFFE, "too many distinct thresholds"
        bin_edges.append(edges)

    tree_feat, tree_bin, tree_thr, tree_child, tree_val = [], [], [], [], []
    max_nodes, max_depth = 1, 0
    for t in range(T):
        order = [0]
        left = []
        depth_of = [0]
        i = 0
        while i < len(order):
            d = order[i]
            if feats[t, d] >= 0 and 2 * d + 2 < N:
                left.append(len(order))
                order.append(2 * d + 1)
                order.append(2 * d + 2)
                depth_of.append(depth_of[i] + 1)
                depth_of.append(depth_of[i] + 1)
            else:
                left.append(i)                      # leaf: self-loop
            i += 1
        m = len(order)
        oa = np.asarray(order)
        lf = np.asarray(left, np.int32)
        fe = feats[t, oa]
        is_leaf = lf == np.arange(m, dtype=np.int32)
        f_packed = np.where(is_leaf, 0, np.maximum(fe, 0)).astype(np.int32)
        th = thrs[t, oa]
        tb = np.empty(m, np.uint16)
        for j in range(m):
            if is_leaf[j]:
                tb[j] = _LEAF_BIN
            else:
                e = bin_edges[fe[j]]
                tb[j] = np.searchsorted(e, th[j], side="left") + 1
        tree_feat.append(f_packed)
        tree_bin.append(tb)
        tree_thr.append(np.where(is_leaf, np.float32(np.inf), th))
        tree_child.append(lf)
        tree_val.append(vals[t, oa])
        max_nodes = max(max_nodes, m)
        max_depth = max(max_depth, max(depth_of))

    total = sum(a.shape[0] for a in tree_feat)
    flat_feat = np.empty(total, np.int32)
    flat_bin = np.empty(total, np.uint16)
    flat_child = np.empty(total, np.int32)
    flat_val = np.empty(total, np.float32)
    roots = np.empty(T, np.int32)
    pfeat = np.zeros((T, max_nodes), np.int32)
    pthr = np.full((T, max_nodes), np.inf, np.float32)
    pchild = np.tile(np.arange(max_nodes, dtype=np.int32), (T, 1))
    pvalue = np.zeros((T, max_nodes), np.float32)
    off = 0
    for t in range(T):
        m = tree_feat[t].shape[0]
        roots[t] = off
        flat_feat[off:off + m] = tree_feat[t]
        flat_bin[off:off + m] = tree_bin[t]
        flat_child[off:off + m] = tree_child[t] + off
        flat_val[off:off + m] = tree_val[t]
        pfeat[t, :m] = tree_feat[t]
        pthr[t, :m] = tree_thr[t]
        pchild[t, :m] = tree_child[t]
        pvalue[t, :m] = tree_val[t]
        off += m

    return PackedEnsemble(
        feat=flat_feat, thr_bin=flat_bin, child=flat_child, value=flat_val,
        roots=roots, pfeat=pfeat, pthr=pthr, pchild=pchild, pvalue=pvalue,
        bin_edges=bin_edges, n_classes=model.n_classes,
        n_features=n_features, depth=max_depth,
        base_score=float(model.base_score))
