"""Histogram gradient-boosted trees: the Clairvoyant predictor's model.

The trainers (``train_gbdt`` and its helpers, and the seed per-node
``train_gbdt_reference``) are exact copies of those in ``repro.core.gbdt``,
so both packages grow identical trees from the same data; ``save`` and
``load`` pickle the same dataclass fields, so a file either package
writes loads in the other.  Scoring differs: the JAX package scores on the host; the
port scores on the card (its plain PyTorch versions on the CPU) through
two layouts of the same trees:

* the dense complete-tree tensors (``predict_margin_dense``,
  ``kernels.ops.gbdt_margins``: K4);
* the pruned packed layout of ``core.ensemble_pack`` (``packed()``,
  ``kernels.ops.gbdt_margins_packed``: K5).

``predict_margin`` scores every batch, a single row (one admission, the
JAX ``Predictor._single_path``) or an arrival burst (the JAX
``proba_batch``), through the packed layout, as the JAX model does;
``predict_margin_dense`` is the dense oracle.  Both add ``base_score``.
"""

from __future__ import annotations

import dataclasses
import pickle
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models.model import resolve_device

MAX_BINS = 256


@dataclass
class GBDTParams:
    num_rounds: int = 300
    max_depth: int = 6
    learning_rate: float = 0.1
    reg_lambda: float = 1.0
    min_child_weight: float = 1.0
    gamma: float = 0.0
    n_classes: int = 3
    seed: int = 42
    subsample: float = 1.0


@dataclass
class GBDTModel:
    """Dense complete-binary-tree ensemble.

    All arrays have leading dim T = num_rounds * n_classes (tree t belongs to
    class ``t % n_classes``) and node dim N = 2**(max_depth+1) - 1 in
    breadth-first layout (children of i at 2i+1 / 2i+2).  ``feature[i] < 0``
    marks a leaf; traversal goes left iff x[feature] < threshold.
    """

    feature: np.ndarray    # (T, N) int32, -1 for leaf / dead node
    threshold: np.ndarray  # (T, N) float32
    value: np.ndarray      # (T, N) float32 (leaf contribution)
    n_classes: int
    max_depth: int
    base_score: float = 0.0

    @property
    def num_trees(self) -> int:
        return self.feature.shape[0]

    def tensors(self, device) -> tuple:
        """(feature int32, threshold, value) on ``device``, copied once."""
        device = torch.device(device)
        cache = self.__dict__.setdefault("_tensors", {})
        if device not in cache:
            cache[device] = tuple(
                torch.as_tensor(np.ascontiguousarray(a), device=device)
                for a in (self.feature.astype(np.int32),
                          self.threshold.astype(np.float32),
                          self.value.astype(np.float32)))
        return cache[device]

    def packed(self, rebuild: bool = False):
        """Pruned packed export (cached; see ``core.ensemble_pack``).

        The cache is keyed on identity only: call ``packed(rebuild=True)``
        after mutating the ensemble tensors in place."""
        cached = self.__dict__.get("_packed")
        if cached is None or rebuild:
            from repro_torch.core.ensemble_pack import pack_ensemble
            cached = pack_ensemble(self)
            self.__dict__["_packed"] = cached
        return cached

    def predict_margin_dense(self, X: np.ndarray, device=None) -> np.ndarray:
        """(B, n_classes) raw margins through the dense layout (K4 on the
        card), scored on ``device``: the card unless the caller names one
        (``device='cpu'`` for the plain walk on the host); raises when no
        card is present and none is named."""
        device = resolve_device(device)
        x = torch.as_tensor(np.asarray(X, np.float32), device=device)
        m = ops.gbdt_margins(x.contiguous(), *self.tensors(device),
                             n_classes=self.n_classes)
        return (m + self.base_score).cpu().numpy()

    def predict_margin(self, X: np.ndarray, device=None) -> np.ndarray:
        """(B, n_classes) raw margins on ``device`` (same rule as
        :meth:`predict_margin_dense`), every batch size through the packed
        layout (K5 on the card), as the JAX model always scores packed;
        :meth:`predict_margin_dense` (K4) is the dense oracle."""
        return self.packed().predict_margin(X, device)

    def predict_proba(self, X: np.ndarray, device=None) -> np.ndarray:
        """Softmax of :meth:`predict_margin` (same device rule)."""
        return _softmax(self.predict_margin(X, device))

    def predict_p_long(self, X: np.ndarray, long_class: int = 2,
                       device=None) -> np.ndarray:
        """The scheduler's priority key (same device rule)."""
        return self.predict_proba(X, device)[:, long_class]

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump({fl.name: getattr(self, fl.name)
                         for fl in dataclasses.fields(self)}, f)

    @classmethod
    def load(cls, path: str) -> "GBDTModel":
        with open(path, "rb") as f:
            d = pickle.load(f)
        return cls(**d)


# ---------------------------------------------------------------------------
# Training (exact copy of repro.core.gbdt's fast trainer)
# ---------------------------------------------------------------------------

def _bin_features(X: np.ndarray):
    """Pre-bin features; returns (binned uint8 (B,F), thresholds list[F])."""
    B, F = X.shape
    binned = np.zeros((B, F), np.uint8)
    thresholds = []
    for f in range(F):
        vals = np.unique(X[:, f])
        if len(vals) > MAX_BINS:
            qs = np.quantile(X[:, f], np.linspace(0, 1, MAX_BINS + 1)[1:-1])
            edges = np.unique(qs)
        else:
            edges = (vals[:-1] + vals[1:]) / 2.0  # midpoints between uniques
        thresholds.append(edges.astype(np.float32))
        binned[:, f] = np.searchsorted(edges, X[:, f], side="right")
    return binned, thresholds


def _softmax(m):
    m = m - m.max(axis=1, keepdims=True)
    e = np.exp(m)
    return e / e.sum(axis=1, keepdims=True)


def train_gbdt(X: np.ndarray, y: np.ndarray,
               params: GBDTParams | None = None) -> GBDTModel:
    """Fit the boosted ensemble.  X: (B, F) float; y: (B,) int class labels."""
    p = params or GBDTParams()
    rng = np.random.default_rng(p.seed)
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.int64)
    B, F = X.shape
    K = p.n_classes
    N = 2 ** (p.max_depth + 1) - 1
    T = p.num_rounds * K

    binned, thresholds = _bin_features(X)
    y_onehot = np.eye(K, dtype=np.float32)[y]

    feature = np.full((T, N), -1, np.int32)
    threshold = np.zeros((T, N), np.float32)
    value = np.zeros((T, N), np.float32)

    margins = np.zeros((B, K), np.float32)

    # Invariants hoisted out of the per-tree loop.  The histogram axis is
    # *compact*: feature f owns len(thresholds[f])+1 adjacent columns (its
    # real bin count), not a fixed MAX_BINS stripe — for the 19 mostly
    # boolean/low-cardinality Clairvoyant features this shrinks every
    # histogram, cumsum, and gain pass by an order of magnitude.
    nb = np.asarray([len(th) + 1 for th in thresholds], np.int32)
    off = np.zeros(F, np.int32)
    np.cumsum(nb[:-1], out=off[1:])
    layout = _BinLayout(
        off=off,
        total=int(nb.sum()),
        col2f=np.repeat(np.arange(F, dtype=np.int32), nb),
        col2b=np.concatenate([np.arange(n, dtype=np.int32) for n in nb]),
        basecol=np.repeat(off, nb).astype(np.intp),
        valid=np.concatenate([(np.arange(n) < n - 1) for n in nb]),
    )
    keys = binned.astype(np.int32) + off[None, :]            # (B, F)

    t = 0
    for _round in range(p.num_rounds):
        probs = _softmax(margins)
        G_all = probs - y_onehot                     # (B, K)
        H_all = np.maximum(probs * (1.0 - probs), 1e-6)
        if p.subsample < 1.0:
            mask = rng.random(B) < p.subsample
        else:
            mask = None
        for k in range(K):
            g, h = G_all[:, k], H_all[:, k]
            if mask is not None:
                g, h = g * mask, h * mask
            leaf = _build_tree(binned, thresholds, keys, layout, g, h, p,
                               feature[t], threshold[t], value[t])
            # routing computed during growth — no re-traversal
            margins[:, k] += value[t][leaf]
            t += 1

    return GBDTModel(feature=feature, threshold=threshold, value=value,
                     n_classes=K, max_depth=p.max_depth)


@dataclass
class _BinLayout:
    """Compact histogram axis: feature f owns columns off[f]..off[f]+nb-1."""
    off: np.ndarray       # (F,) first column of each feature
    total: int            # total histogram columns
    col2f: np.ndarray     # (total,) owning feature of each column
    col2b: np.ndarray     # (total,) local bin of each column
    basecol: np.ndarray   # (total,) off[col2f], for segmented cumsum
    valid: np.ndarray     # (total,) bool, splittable columns


def _depth_hist(keys, layout, comp_of_row, rows, g, h, n_nodes):
    """Histograms for ``n_nodes`` compact node ids over ``rows`` in one
    bincount pair.  Returns (G, H) of shape (n_nodes, total_cols)."""
    F = keys.shape[1]
    stride = layout.total
    ck = (keys[rows] + (comp_of_row * stride)[:, None]).ravel()
    wg = np.repeat(g[rows], F)
    wh = np.repeat(h[rows], F)
    Gh = np.bincount(ck, weights=wg, minlength=n_nodes * stride)
    Hh = np.bincount(ck, weights=wh, minlength=n_nodes * stride)
    return Gh.reshape(n_nodes, stride), Hh.reshape(n_nodes, stride)


def _seg_cumsum(H, layout):
    """Within-feature prefix sums over the compact column axis."""
    csp = np.zeros((H.shape[0], layout.total + 1), H.dtype)
    np.cumsum(H, axis=1, out=csp[:, 1:])
    return csp[:, 1:] - csp[:, layout.basecol]


def _build_tree(binned, thresholds, keys, layout, g, h, p: GBDTParams,
                feature_out, threshold_out, value_out):
    """Grow one depth-wise tree in place; returns each sample's leaf slot.

    Per depth: score every frontier node's splits in one vectorized
    ``(nodes, total_bins)`` pass, route samples of splitting nodes, then
    bin only the smaller child of each split (sibling = parent - small).

    Sibling subtraction accumulates ~1e-6 relative float drift in the
    derived histograms, so near-tied split gains can resolve differently
    than in ``_build_tree_reference`` — the two trainers produce
    equal-quality but not structurally identical ensembles (most visibly
    with ``subsample < 1``).  Determinism for a fixed seed is unaffected.
    """
    B, F = binned.shape
    lam, lr, mcw = p.reg_lambda, p.learning_rate, p.min_child_weight
    N = feature_out.shape[0]
    nb0 = int(layout.off[1]) if F > 1 else layout.total

    node = np.zeros(B, np.int32)          # current slot per sample
    active = np.ones(B, bool)             # rows not yet settled at a leaf
    all_rows = np.arange(B)

    slots = np.zeros(1, np.int64)         # frontier node slots at this depth
    Gh, Hh = _depth_hist(keys, layout, np.zeros(B, np.int64), all_rows,
                         g, h, 1)
    counts = np.asarray([B])

    for depth in range(p.max_depth + 1):
        n = slots.shape[0]
        gs = Gh[:, :nb0].sum(axis=1)                       # (n,) node totals
        hs = Hh[:, :nb0].sum(axis=1)
        value_out[slots] = -lr * gs / (hs + lam)
        can_split = (depth < p.max_depth) & (counts >= 2) & (hs >= 2 * mcw)
        if not can_split.any():
            break
        GL = _seg_cumsum(Gh, layout)                       # (n, total)
        HL = _seg_cumsum(Hh, layout)
        GR = gs[:, None] - GL
        HR = hs[:, None] - HL
        ok = (HL >= mcw) & (HR >= mcw) & layout.valid[None]
        with np.errstate(divide="ignore", invalid="ignore"):
            gain = 0.5 * (GL ** 2 / (HL + lam) + GR ** 2 / (HR + lam)
                          - (gs ** 2 / (hs + lam))[:, None]) - p.gamma
        gain = np.where(ok, gain, -np.inf)
        bidx = gain.argmax(axis=1)
        best = gain[np.arange(n), bidx]
        do = can_split & np.isfinite(best) & (best > 0)
        if not do.any():
            break
        f_best = layout.col2f[bidx]
        b_best = layout.col2b[bidx]
        sslots = slots[do]
        feature_out[sslots] = f_best[do]
        threshold_out[sslots] = [thresholds[f][b]
                                 for f, b in zip(f_best[do], b_best[do])]

        # route the rows of splitting nodes; everyone else settles
        sf = np.full(N, -1, np.int32)
        sb = np.zeros(N, np.int32)
        sf[sslots] = f_best[do]
        sb[sslots] = b_best[do]
        rows = all_rows[active]
        nf = sf[node[rows]]
        splitting = nf >= 0
        active[rows[~splitting]] = False
        rows = rows[splitting]
        nf = nf[splitting]
        go_left = binned[rows, nf] <= sb[node[rows]]
        node[rows] = 2 * node[rows] + 2 - go_left

        # histogram subtraction: bin the smaller child, derive the sibling
        cnts = np.bincount(node[rows], minlength=N)
        lch = 2 * sslots + 1
        rch = 2 * sslots + 2
        left_small = cnts[lch] <= cnts[rch]
        small = np.where(left_small, lch, rch)
        big = np.where(left_small, rch, lch)
        comp = np.full(N, -1, np.int64)
        comp[small] = np.arange(small.shape[0])
        crow = comp[node[rows]]
        sel = crow >= 0
        Gh_s, Hh_s = _depth_hist(keys, layout, crow[sel], rows[sel], g, h,
                                 small.shape[0])
        Gh_b = Gh[do] - Gh_s
        Hh_b = Hh[do] - Hh_s
        slots = np.concatenate([small, big])
        Gh = np.concatenate([Gh_s, Gh_b])
        Hh = np.concatenate([Hh_s, Hh_b])
        counts = np.concatenate([cnts[small], cnts[big]])
    return node


def _eval_tree_binned(binned, thresholds, feature, threshold, value, X):
    """Dense single-tree traversal (kept as an oracle for the trainer)."""
    B = X.shape[0]
    idx = np.zeros(B, np.int32)
    depth = int(np.log2(feature.shape[0] + 1)) - 1
    for _ in range(depth):
        feat = feature[idx]
        leaf = feat < 0
        f = np.maximum(feat, 0)
        go_left = X[np.arange(B), f] < threshold[idx]
        nxt = np.where(go_left, 2 * idx + 1, 2 * idx + 2)
        idx = np.where(leaf, idx, nxt)
    return value[idx]


# ---------------------------------------------------------------------------
# Reference (seed) trainer — per-node histograms, full re-traversal per
# round (exact copy of repro.core.gbdt's).
# ---------------------------------------------------------------------------

def train_gbdt_reference(X: np.ndarray, y: np.ndarray,
                         params: GBDTParams | None = None) -> GBDTModel:
    """Seed implementation of :func:`train_gbdt` (slow; the oracle)."""
    p = params or GBDTParams()
    rng = np.random.default_rng(p.seed)
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.int64)
    B, F = X.shape
    K = p.n_classes
    N = 2 ** (p.max_depth + 1) - 1
    T = p.num_rounds * K

    binned, thresholds = _bin_features(X)
    y_onehot = np.eye(K, dtype=np.float32)[y]

    feature = np.full((T, N), -1, np.int32)
    threshold = np.zeros((T, N), np.float32)
    value = np.zeros((T, N), np.float32)
    margins = np.zeros((B, K), np.float32)

    t = 0
    for _round in range(p.num_rounds):
        probs = _softmax(margins)
        G_all = probs - y_onehot
        H_all = np.maximum(probs * (1.0 - probs), 1e-6)
        if p.subsample < 1.0:
            mask = rng.random(B) < p.subsample
        else:
            mask = None
        for k in range(K):
            g, h = G_all[:, k].copy(), H_all[:, k].copy()
            if mask is not None:
                g, h = g * mask, h * mask
            _build_tree_reference(binned, thresholds, g, h, p,
                                  feature[t], threshold[t], value[t])
            margins[:, k] += _eval_tree_binned(
                binned, thresholds, feature[t], threshold[t], value[t], X)
            t += 1

    return GBDTModel(feature=feature, threshold=threshold, value=value,
                     n_classes=K, max_depth=p.max_depth)


def _build_tree_reference(binned, thresholds, g, h, p: GBDTParams,
                          feature_out, threshold_out, value_out):
    """Seed tree grower: one histogram pair per node, per-node np.repeat."""
    B, F = binned.shape
    lam = p.reg_lambda
    keys_full = (binned.astype(np.int32)
                 + np.arange(F, dtype=np.int32)[None, :] * MAX_BINS)
    active = {0: np.arange(B)}

    def leaf_weight(gs, hs):
        return float(-p.learning_rate * gs / (hs + lam))

    for depth in range(p.max_depth + 1):
        next_active = {}
        for node, idx in active.items():
            gs, hs = float(g[idx].sum()), float(h[idx].sum())
            value_out[node] = leaf_weight(gs, hs)
            if depth == p.max_depth or len(idx) < 2 \
                    or hs < 2 * p.min_child_weight:
                continue  # stays leaf (feature_out[node] == -1)
            keys = keys_full[idx].ravel()
            Gh = np.bincount(keys, weights=np.repeat(g[idx], F),
                             minlength=F * MAX_BINS).reshape(F, MAX_BINS)
            Hh = np.bincount(keys, weights=np.repeat(h[idx], F),
                             minlength=F * MAX_BINS).reshape(F, MAX_BINS)
            GL = np.cumsum(Gh, axis=1)[:, :-1]
            HL = np.cumsum(Hh, axis=1)[:, :-1]
            GR, HR = gs - GL, hs - HL
            valid = (HL >= p.min_child_weight) & (HR >= p.min_child_weight)
            with np.errstate(divide="ignore", invalid="ignore"):
                gain = 0.5 * (GL ** 2 / (HL + lam) + GR ** 2 / (HR + lam)
                              - gs ** 2 / (hs + lam)) - p.gamma
            gain = np.where(valid, gain, -np.inf)
            for f in range(F):
                gain[f, len(thresholds[f]):] = -np.inf
            best = np.unravel_index(np.argmax(gain), gain.shape)
            if not np.isfinite(gain[best]) or gain[best] <= 0:
                continue
            f_best, b_best = int(best[0]), int(best[1])
            feature_out[node] = f_best
            threshold_out[node] = thresholds[f_best][b_best]
            go_left = binned[idx, f_best] <= b_best
            next_active[2 * node + 1] = idx[go_left]
            next_active[2 * node + 2] = idx[~go_left]
        active = next_active
        if not active:
            break
