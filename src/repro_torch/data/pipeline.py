"""Dataset filtering / splitting pipeline (paper §4.2 "data filtering recipe"
and Table 3 splits).

Mirrors data/pipeline/featurize.py from the paper's artifact: first-turn
extraction and language filtering are structural no-ops for the synthetic
corpora (we generate single-turn English), but the hooks are kept so a real
corpus drops in unchanged.  Class boundaries, stratified balancing, and the
80/10/10 stratified split match the paper exactly (seed 42).

A copy of ``repro.data.pipeline`` over the port's own ``core.features``,
``core.ranking`` and ``data.corpus``: the splits are the same arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.features import extract_batch
from repro_torch.core.ranking import class_labels
from repro_torch.data.corpus import Dataset, sample_dataset

# Table 3: per-class split sizes for each trained model
MODEL_SPLITS = {
    "A": {"dataset": "sharegpt", "train": 1600, "val": 200, "test": 200},
    "B": {"dataset": "lmsys", "train": 1600, "val": 200, "test": 200},
    "C": {"dataset": "oasst1", "train": 220, "val": 28, "test": 28},
}


@dataclass
class Split:
    X: np.ndarray          # (N, 19) features
    y: np.ndarray          # (N,) class labels
    lengths: np.ndarray    # (N,) true response tokens
    prompts: list

    def __len__(self):
        return len(self.y)


@dataclass
class DataSplits:
    train: Split
    val: Split
    test: Split


def featurize(ds: Dataset) -> Tuple[np.ndarray, np.ndarray]:
    """(features, labels) — step (3)+(4) of the recipe."""
    X = extract_batch(ds.prompts)
    y = class_labels(ds.lengths)
    return X, y


def stratified_split(ds: Dataset, per_class: Dict[str, int],
                     seed: int = 42) -> DataSplits:
    """Balanced per-class train/val/test split (Table 3)."""
    rng = np.random.default_rng(seed)
    X, y = featurize(ds)
    idx_by_class = [np.where(y == c)[0] for c in range(3)]
    parts: Dict[str, list] = {"train": [], "val": [], "test": []}
    for c, idx in enumerate(idx_by_class):
        idx = idx.copy()
        rng.shuffle(idx)
        need = per_class["train"] + per_class["val"] + per_class["test"]
        if len(idx) < need:
            raise ValueError(
                f"class {c}: need {need} examples, corpus has {len(idx)} — "
                "Long-class starvation (the paper's Table 2 finding)")
        o = 0
        for part in ("train", "val", "test"):
            k = per_class[part]
            parts[part].append(idx[o:o + k])
            o += k

    def mk(name):
        sel = np.concatenate(parts[name])
        rng.shuffle(sel)
        return Split(X=X[sel], y=y[sel], lengths=ds.lengths[sel],
                     prompts=[ds.prompts[i] for i in sel])

    return DataSplits(train=mk("train"), val=mk("val"), test=mk("test"))


def load_model_splits(model: str, seed: int = 42,
                      oversample: int = 4) -> DataSplits:
    """Build the Table 3 splits for Model A/B/C from the synthetic profiles.

    ``oversample`` draws a larger raw pool so every class has enough examples
    to fill its balanced quota (the generator is unbalanced like the source)."""
    spec = MODEL_SPLITS[model]
    need = (spec["train"] + spec["val"] + spec["test"]) * 3
    from repro_torch.data.corpus import PROFILES
    p_min = PROFILES[spec["dataset"]].class_probs.min()
    n_raw = int(need / max(p_min, 1e-6) * 1.2) + 500
    ds = sample_dataset(spec["dataset"], n=n_raw, seed=seed)
    per_class = {k: spec[k] for k in ("train", "val", "test")}
    return stratified_split(ds, per_class, seed=seed)


def heldout_eval_set(dataset: str, n: int = 600, seed: int = 7) -> Split:
    """Unbalanced-source, class-balanced eval set of n examples (Table 6
    cross-distribution cells use n=600)."""
    ds = sample_dataset(dataset, n=max(3 * n, 6000), seed=seed)
    X, y = featurize(ds)
    rng = np.random.default_rng(seed + 1)
    sel = []
    per = n // 3
    for c in range(3):
        idx = np.where(y == c)[0]
        rng.shuffle(idx)
        take = idx[:per]
        if len(take) < per:  # degenerate profiles (alpaca/cnn): take what exists
            pass
        sel.append(take)
    sel = np.concatenate(sel)
    rng.shuffle(sel)
    return Split(X=X[sel], y=y[sel], lengths=ds.lengths[sel],
                 prompts=[ds.prompts[i] for i in sel])
