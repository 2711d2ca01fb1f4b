"""The Clairvoyant predictor: features -> GBDT -> P(Long).

Admission scores whole bursts: ``proba_batch`` extracts the 19 lexical
features on the host (``features.extract_batch``) and scores them with the
K4 kernel on ``device`` (its plain version when ``device`` is the CPU).
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

    def proba_batch(self, prompts: Sequence[str]) -> np.ndarray:
        return self.model.predict_proba(F.extract_batch(prompts), self.device)

    def p_long_batch(self, prompts: Sequence[str]) -> np.ndarray:
        return self.proba_batch(prompts)[:, LONG_CLASS]

    @classmethod
    def train(cls, prompts: Sequence[str], response_lengths: Sequence[int],
              params: Optional[GBDTParams] = None,
              device=None) -> "Predictor":
        X = F.extract_batch(prompts)
        y = class_labels(response_lengths)
        return cls(train_gbdt(X, y, params or GBDTParams()), device)
