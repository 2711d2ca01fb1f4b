"""The port's ranking metric (paper Algorithm 1) and Table 7 baselines:
the properties of tests/test_ranking.py, held on ``repro_torch.core.
ranking``, and equality with the JAX package's functions on seeded
inputs (the module is a numpy copy, so results are compared exactly,
NaN included)."""

import torch_threads  # noqa: F401  (first: caps torch threads)

import numpy as np
import pytest

from repro.core import ranking as jranking
from repro_torch.core.ranking import (class_labels, class_of,
                                      classification_accuracy,
                                      fit_prompt_length_threshold,
                                      keyword_heuristic_scores,
                                      prompt_length_rule_scores,
                                      ranking_accuracy)


def test_perfect_ranker_scores_one():
    lengths = np.array([50, 60, 1000, 2000])
    scores = np.array([0.1, 0.2, 0.8, 0.9])
    assert ranking_accuracy(lengths, scores) == 1.0


def test_inverted_ranker_scores_zero():
    lengths = np.array([50, 60, 1000, 2000])
    scores = np.array([0.9, 0.8, 0.2, 0.1])
    assert ranking_accuracy(lengths, scores) == 0.0


def test_medium_excluded():
    lengths = np.array([50, 400, 500, 1000])
    a = ranking_accuracy(lengths, np.array([0.1, 0.0, 1.0, 0.9]))
    b = ranking_accuracy(lengths, np.array([0.1, 0.9, 0.1, 0.9]))
    assert a == b == 1.0


def test_ties_conventions():
    lengths = np.array([50, 1000])
    tied = np.array([0.5, 0.5])
    assert ranking_accuracy(lengths, tied, ties="loss") == 0.0
    assert ranking_accuracy(lengths, tied, ties="half") == 0.5


def test_matches_naive_pair_count():
    """The sorted metric equals the O(n^2) pair count (seeded loop)."""
    rng = np.random.default_rng(0)
    for _ in range(100):
        n = int(rng.integers(2, 120))
        lengths = rng.integers(0, 3000, n)
        scores = rng.random(n)
        if rng.random() < 0.3:                 # force score ties
            scores = np.round(scores, 1)
        s = scores[lengths < 200]
        lo = scores[lengths >= 800]
        if len(s) == 0 or len(lo) == 0:
            assert np.isnan(ranking_accuracy(lengths, scores))
            continue
        naive = sum(float(lj > si) for si in s for lj in lo) \
            / (len(s) * len(lo))
        assert abs(ranking_accuracy(lengths, scores) - naive) < 1e-12


def test_scale_invariance():
    """An exact monotone transform (a power-of-two scale) leaves the
    metric unchanged."""
    rng = np.random.default_rng(1)
    for _ in range(100):
        n = int(rng.integers(2, 60))
        lengths = rng.integers(0, 3000, n)
        scores = rng.random(n)
        a = ranking_accuracy(lengths, scores)
        b = ranking_accuracy(lengths, scores * 8.0)
        assert (np.isnan(a) and np.isnan(b)) or a == b


def test_class_labels_boundaries():
    np.testing.assert_array_equal(
        class_labels(np.array([0, 199, 200, 799, 800])), [0, 0, 1, 1, 2])
    assert [class_of(n) for n in (0, 199, 200, 799, 800)] == [0, 0, 1, 1, 2]


def test_length_rule_threshold_fits_train():
    rng = np.random.default_rng(0)
    lengths = rng.choice([50, 1500], 400)
    plens = np.where(lengths > 800, 30, 10) + rng.integers(0, 5, 400)
    thr = fit_prompt_length_threshold(plens, lengths)
    acc = ranking_accuracy(lengths, prompt_length_rule_scores(plens, thr),
                           ties="half")
    assert acc > 0.9


def _same(a, b):
    return (np.isnan(a) and np.isnan(b)) or a == b


@pytest.mark.parametrize("seed", range(4))
def test_equals_jax_ranking_on_seeded_inputs(seed):
    """Every function of the module gives the JAX module's result on the
    same seeded lengths, scores, probabilities, prompt lengths and
    features."""
    rng = np.random.default_rng(seed)
    n = 300
    lengths = rng.integers(0, 3000, n)
    scores = np.round(rng.random(n), 2)       # ties included
    proba = rng.dirichlet(np.ones(3), n)
    plens = rng.integers(1, 200, n)
    feats = rng.integers(0, 2, (n, 19)).astype(np.float64)
    for ties in ("loss", "half"):
        assert _same(ranking_accuracy(lengths, scores, ties=ties),
                     jranking.ranking_accuracy(lengths, scores, ties=ties))
    np.testing.assert_array_equal(class_labels(lengths),
                                  jranking.class_labels(lengths))
    assert classification_accuracy(lengths, proba) == \
        jranking.classification_accuracy(lengths, proba)
    thr = fit_prompt_length_threshold(plens, lengths)
    assert thr == jranking.fit_prompt_length_threshold(plens, lengths)
    np.testing.assert_array_equal(
        prompt_length_rule_scores(plens, thr),
        jranking.prompt_length_rule_scores(plens, thr))
    np.testing.assert_array_equal(keyword_heuristic_scores(feats),
                                  jranking.keyword_heuristic_scores(feats))
