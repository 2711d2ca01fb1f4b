"""Ranking-accuracy metric (paper §4.1, Algorithm 1) and baselines (Table 7).

Ranking accuracy = fraction of (Short, Long) pairs where the model scores the
Long example strictly higher.  Medium examples are excluded.  Vectorised via
sorting: O((|S|+|L|) log |S|) instead of the naive |S| x |L| product.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

SHORT_MAX = 200   # response tokens: Short < 200
LONG_MIN = 800    # Long >= 800


def class_of(response_tokens: int) -> int:
    """0=Short, 1=Medium, 2=Long (paper's 3-class formulation)."""
    if response_tokens < SHORT_MAX:
        return 0
    if response_tokens < LONG_MIN:
        return 1
    return 2


def class_labels(lengths: np.ndarray) -> np.ndarray:
    lengths = np.asarray(lengths)
    return np.where(lengths < SHORT_MAX, 0,
                    np.where(lengths < LONG_MIN, 1, 2)).astype(np.int64)


def ranking_accuracy(lengths: np.ndarray, scores: np.ndarray,
                     ties: str = "loss") -> float:
    """Algorithm 1.  ``lengths``: true response token counts;
    ``scores``: predicted P(Long).  ties='loss' counts equal scores as
    failures (the paper's strict inequality); ties='half' scores them 0.5
    (used for the coarse baselines whose scores are heavily tied).
    """
    lengths = np.asarray(lengths)
    scores = np.asarray(scores, np.float64)
    s_scores = np.sort(scores[lengths < SHORT_MAX])
    l_scores = scores[lengths >= LONG_MIN]
    if len(s_scores) == 0 or len(l_scores) == 0:
        return float("nan")
    # for each long score: count shorts strictly below / equal
    below = np.searchsorted(s_scores, l_scores, side="left")
    upto = np.searchsorted(s_scores, l_scores, side="right")
    correct = below.sum()
    if ties == "half":
        correct = correct + 0.5 * (upto - below).sum()
    return float(correct) / (len(s_scores) * len(l_scores))


def classification_accuracy(lengths: np.ndarray, proba: np.ndarray) -> float:
    """3-class accuracy (the metric ranking accuracy beats by 21-29 pp)."""
    y = class_labels(lengths)
    return float((proba.argmax(axis=1) == y).mean())


# ---------------------------------------------------------------------------
# Baselines (Table 7)
# ---------------------------------------------------------------------------

def prompt_length_rule_scores(prompt_lens: np.ndarray,
                              threshold: float) -> np.ndarray:
    """Binary score: predicted-long iff prompt token length > threshold."""
    return (np.asarray(prompt_lens) > threshold).astype(np.float64)


def fit_prompt_length_threshold(prompt_lens: np.ndarray,
                                lengths: np.ndarray) -> float:
    """Optimise the rule threshold on the training split (paper Table 7)."""
    cands = np.unique(np.asarray(prompt_lens))
    best_t, best_a = 0.0, -1.0
    for t in cands:
        a = ranking_accuracy(lengths, prompt_length_rule_scores(prompt_lens, t),
                             ties="half")
        if a > best_a:
            best_a, best_t = a, float(t)
    return best_t


def keyword_heuristic_scores(features: np.ndarray) -> np.ndarray:
    """Rule-based score: prompts that *mention* code or structured formats
    are guessed Long.  On chat distributions where code questions get terse
    answers this anti-correlates — the paper measures 4.6-36.3%, far below
    random.  Evaluate with ties='half' (binary scores are heavily tied).
    """
    f = np.asarray(features)
    return f[:, 1] + f[:, 4]  # has_code_keyword + has_format_keyword
