"""The Clairvoyant predictor: features -> GBDT -> P(Long).

Features are extracted on the host (``core.features``); the ensemble is
scored on ``device`` (its plain PyTorch versions when ``device`` is the
CPU).  As in the JAX package there are two admission paths over the same
trained ensemble:

* ``p_long`` / ``proba`` -- one request at a time (the sidecar admits
  each HTTP request as it arrives): one feature row;
* ``proba_batch`` / ``p_long_batch`` -- an arrival burst scored in one
  call.

Both score through the packed layout, K5 on the card, as the JAX model
always scores packed.

Scoring runs on the caller's current CUDA stream, the one the engine
decodes on.  The eager decode loop is host-bound (the host enqueues its
kernels slower than the card runs them), so that stream's queue stays
shallow and an admission does not wait behind a decode segment.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core import features as F
from repro_torch.core.gbdt import GBDTModel, GBDTParams, train_gbdt
from repro_torch.models.model import resolve_device

LONG_CLASS = 2
SHORT_MAX = 200   # response tokens: Short < 200
LONG_MIN = 800    # Long >= 800


def class_labels(lengths) -> np.ndarray:
    """0 = Short, 1 = Medium, 2 = Long (the paper's 3-class split)."""
    lengths = np.asarray(lengths)
    return np.where(lengths < SHORT_MAX, 0,
                    np.where(lengths < LONG_MIN, 1, 2)).astype(np.int64)


class Predictor:
    def __init__(self, model: GBDTModel, device=None):
        self.model = model
        self.device = resolve_device(device)

    def features(self, prompt: str) -> np.ndarray:
        return F.extract(prompt)

    def proba_features(self, X: np.ndarray) -> np.ndarray:
        """(B, 3) class probabilities of feature rows X (B, F), through
        the packed layout (K5 on the card)."""
        return self.model.predict_proba(X, self.device)

    def proba(self, prompt: str) -> np.ndarray:
        return self.proba_features(F.extract(prompt)[None])[0]

    def p_long(self, prompt: str) -> float:
        return float(self.proba(prompt)[LONG_CLASS])

    def proba_batch(self, prompts: Sequence[str]) -> np.ndarray:
        return self.proba_features(F.extract_batch(prompts))

    def p_long_batch(self, prompts: Sequence[str]) -> np.ndarray:
        return self.proba_batch(prompts)[:, LONG_CLASS]

    @classmethod
    def train(cls, prompts: Sequence[str], response_lengths: Sequence[int],
              params: Optional[GBDTParams] = None,
              device=None) -> "Predictor":
        X = F.extract_batch(prompts)
        y = class_labels(response_lengths)
        return cls(train_gbdt(X, y, params or GBDTParams()), device)

    @classmethod
    def train_on_features(cls, X: np.ndarray, y: np.ndarray,
                          params: Optional[GBDTParams] = None,
                          device=None) -> "Predictor":
        return cls(train_gbdt(X, y, params or GBDTParams()), device)
