"""Synthetic corpus profiles for the seven evaluated datasets (paper §4.2).

A copy of ``repro.data.corpus``: the port imports nothing of the JAX
package.

The public datasets are not shipped, so they are replaced by generative
profiles that reproduce each dataset's *published statistics* (Table 2
Long-class rates) and its *lexical-signal structure*:

* class mix — e.g. Alpaca's GPT-imposed brevity constraint is modelled
  directly: Long probability 8e-5 (4 in 52,002), which reproduces the paper's
  degenerate-training finding structurally, not just numerically;
* signal strength — per-profile noise on the feature/class coupling sets the
  achievable ranking accuracy (LMSYS-like is clean -> ~95%, ShareGPT-like is
  mixed -> ~76%, OASST1-like is small+noisy -> ~62%);
* domain shift — verb/keyword semantics differ across profiles (in the
  lmsys-like profile code prompts signal Long; in sharegpt-like they skew
  Short), which is what produces the paper's 52-66% cross-distribution band.

Generation order is class -> lexical features -> prompt text -> response
length, so the learnable signal is exactly the lexical features the paper
uses.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.features import INSTRUCTION_VERBS

SHORT, MEDIUM, LONG = 0, 1, 2
CLASS_NAMES = ("short", "medium", "long")

_TOPICS = (
    "the french revolution", "binary search trees", "photosynthesis",
    "the stock market", "quantum entanglement", "sourdough bread",
    "the roman empire", "neural networks", "climate change", "chess openings",
    "the water cycle", "renaissance art", "black holes", "supply chains",
    "genetic drift", "jazz harmony", "plate tectonics", "game theory",
    "the immune system", "medieval castles", "rust ownership",
    "distributed systems", "the krebs cycle", "haiku poetry",
    "orbital mechanics", "tax law", "coffee roasting", "graph colouring",
    "marine ecosystems", "the printing press",
)

_FILLERS = (
    "please", "kindly", "also", "specifically", "ideally", "overall",
    "for context", "as an expert", "for a beginner", "for my homework",
    "for work", "in simple terms", "with examples", "from first principles",
    "carefully", "quickly", "roughly", "accurately",
)

_CLAUSES = (
    "because i need it for a project", "which i find confusing",
    "that my teacher mentioned", "since i am new to this",
    "although i read the wiki", "when i tried it before",
    "if that makes sense", "where it applies in practice",
    "because the documentation is unclear", "which keeps coming up at work",
)

_CODE_SNIPPETS = (
    "a python function", "a javascript class", "an sql query",
    "a sorting algorithm", "a regex pattern", "an api client",
    "a c++ program", "a shell script",
)

_FORMAT_ASKS = (
    "as a table", "as a json object", "as a markdown list",
    "as a csv file", "as a numbered list", "in yaml format",
)

_SHORT_CONSTRAINTS = ("briefly", "in one sentence", "be concise", "tl;dr",
                      "short answer only")
_LONG_CONSTRAINTS = ("in detail", "comprehensive", "step by step",
                     "at length", "as an essay with paragraphs")

# verb indices: what write explain summarize how list implement compare
#               describe generate why define  (+other)
_V = {v: i for i, v in enumerate(INSTRUCTION_VERBS)}


@dataclass
class LexStyle:
    """Feature/class coupling for one dataset profile.

    Two noise knobs shape the accuracy structure: ``noise_adjacent`` leaks
    features to the *neighbouring* class (blurs Short/Medium and Medium/Long
    boundaries -> classification accuracy drops, ranking survives — the
    paper's +21-29 pp ranking-over-classification gap), while
    ``noise_uniform`` leaks to a random class (degrades ranking itself).
    """
    # P(verb-bucket | class): rows = class, entries = (verb_idx, weight)
    verb_affinity: Dict[int, Tuple[Tuple[int, float], ...]]
    verb_strength: float                         # 1 = fully class-coupled, 0 = noise
    code_prob: Tuple[float, float, float]        # P(code keywords | class)
    constraint_prob: Tuple[float, float, float]  # P(length constraint | class)
    question_prob: Tuple[float, float, float]
    format_prob: Tuple[float, float, float]
    clause_rate: Tuple[float, float, float]      # Poisson rate per class
    words_mean: Tuple[float, float, float]       # prompt length (words)
    words_std: Tuple[float, float, float]
    noise_adjacent: float
    noise_uniform: float


@dataclass
class CorpusProfile:
    name: str
    published_total: int
    published_counts: Tuple[int, int, int]   # (short, medium, long) — Table 2
    style: LexStyle
    response_long_mean: float = 1400.0       # mean Long response tokens

    @property
    def class_probs(self) -> np.ndarray:
        c = np.asarray(self.published_counts, float)
        return c / c.sum()


_CANONICAL_VERBS = {   # sharegpt-reference semantics
    SHORT: (("what", 3.0), ("define", 2.0), ("why", 1.0), ("how", 0.5)),
    MEDIUM: (("explain", 2.0), ("summarize", 2.0), ("compare", 1.0),
             ("list", 1.0), ("describe", 1.0)),
    LONG: (("write", 3.0), ("generate", 2.0), ("implement", 1.5),
           ("describe", 0.5)),
}

_LMSYS_VERBS = {       # shifted semantics: 'write X' is a terse request here;
    SHORT: (("write", 2.0), ("what", 2.0), ("define", 1.5), ("list", 1.0)),
    MEDIUM: (("summarize", 2.0), ("compare", 1.5), ("why", 1.0),
             ("generate", 1.0)),
    LONG: (("explain", 2.5), ("how", 2.0), ("describe", 1.5),
           ("implement", 0.5)),
}

_DOLLY_VERBS = {       # mild shift from canonical
    SHORT: (("what", 3.0), ("define", 2.0), ("list", 1.0), ("how", 0.5)),
    MEDIUM: (("explain", 2.0), ("summarize", 2.0), ("why", 1.0),
             ("describe", 1.0)),
    LONG: (("write", 3.0), ("generate", 2.0), ("explain", 1.0)),
}


def _verbs(table):
    return {k: tuple((_V[name], w) for name, w in v) for k, v in table.items()}


def _mk_style(verbs, verb_strength, code_prob, noise_adjacent, noise_uniform,
              words_mean=(9.0, 12.0, 15.0), words_std=(6.0, 9.0, 14.0),
              question_prob=(0.75, 0.40, 0.10),
              format_prob=(0.12, 0.10, 0.08),
              clause_rate=(0.2, 1.0, 2.2),
              constraint_prob=(0.30, 0.06, 0.40)) -> LexStyle:
    return LexStyle(
        verb_affinity=_verbs(verbs),
        verb_strength=verb_strength,
        code_prob=code_prob,
        constraint_prob=constraint_prob,   # short OR long constraints
        question_prob=question_prob,
        format_prob=format_prob,
        clause_rate=clause_rate,
        words_mean=words_mean,
        words_std=words_std,
        noise_adjacent=noise_adjacent,
        noise_uniform=noise_uniform,
    )


PROFILES: Dict[str, CorpusProfile] = {
    # natural conversation logs — viable training sources.
    # Code/format keywords skew SHORT in all profiles (why the paper's
    # keyword heuristic lands below random), with per-profile strength.
    "sharegpt": CorpusProfile(
        name="sharegpt", published_total=48312,
        published_counts=(27000, 17000, 7800),
        style=_mk_style(_CANONICAL_VERBS, 0.9, (0.40, 0.20, 0.08),
                        noise_adjacent=0.40, noise_uniform=0.10)),
    "lmsys": CorpusProfile(
        name="lmsys", published_total=876412,
        published_counts=(520000, 360000, 120000),
        style=_mk_style(_LMSYS_VERBS, 1.0, (0.85, 0.30, 0.02),
                        noise_adjacent=0.28, noise_uniform=0.01,
                        format_prob=(0.30, 0.10, 0.02),
                        constraint_prob=(0.40, 0.06, 0.55),
                        clause_rate=(0.15, 1.2, 3.0))),
    "oasst1": CorpusProfile(
        name="oasst1", published_total=8792,
        published_counts=(7300, 940, 551),
        style=_mk_style(_CANONICAL_VERBS, 0.5, (0.45, 0.20, 0.06),
                        noise_adjacent=0.42, noise_uniform=0.20,
                        format_prob=(0.20, 0.12, 0.06))),
    # curated instruction datasets — degenerate (GPT brevity constraint)
    "alpaca": CorpusProfile(
        name="alpaca", published_total=52002,
        published_counts=(49284, 2056, 4),
        style=_mk_style(_CANONICAL_VERBS, 0.8, (0.30, 0.18, 0.12),
                        noise_adjacent=0.35, noise_uniform=0.15),
        response_long_mean=900.0),
    "codealpaca": CorpusProfile(
        name="codealpaca", published_total=20022,
        published_counts=(19457, 379, 3),
        style=_mk_style(_CANONICAL_VERBS, 0.8, (0.85, 0.80, 0.75),
                        noise_adjacent=0.35, noise_uniform=0.15),
        response_long_mean=900.0),
    # test-only
    "dolly": CorpusProfile(
        name="dolly", published_total=15011,
        published_counts=(13000, 1900, 88),
        style=_mk_style(_DOLLY_VERBS, 0.7, (0.25, 0.15, 0.10),
                        noise_adjacent=0.42, noise_uniform=0.22)),
    "cnn_dailymail": CorpusProfile(
        name="cnn_dailymail", published_total=11490,
        published_counts=(11441, 48, 1),
        style=_mk_style(_CANONICAL_VERBS, 0.8, (0.05, 0.05, 0.05),
                        noise_adjacent=0.30, noise_uniform=0.15),
        response_long_mean=850.0),
}


@dataclass
class Dataset:
    name: str
    prompts: List[str]
    lengths: np.ndarray      # true response token counts
    classes: np.ndarray      # derived 3-class labels

    def __len__(self):
        return len(self.prompts)


def _sample_verb(rng, style: LexStyle, klass: int) -> str:
    # small chance of an out-of-table verb ("other" bucket)
    if rng.random() < 0.08:
        return rng.choice(["craft", "outline", "ponder", "sketch", "assess"])
    # verb_strength < 1 decouples verbs from class (oasst1: verbs ~ noise)
    if rng.random() > style.verb_strength:
        return INSTRUCTION_VERBS[int(rng.integers(0, len(INSTRUCTION_VERBS)))]
    pairs = style.verb_affinity[klass]
    idx = np.array([p[0] for p in pairs])
    w = np.array([p[1] for p in pairs])
    return INSTRUCTION_VERBS[rng.choice(idx, p=w / w.sum())]


def _leak_class(rng, klass: int, style: LexStyle) -> int:
    u = rng.random()
    if u < style.noise_uniform:
        return int(rng.integers(0, 3))
    if u < style.noise_uniform + style.noise_adjacent:
        if klass == MEDIUM:
            return SHORT if rng.random() < 0.5 else LONG
        return MEDIUM  # short/long leak to the boundary class
    return klass


def _gen_prompt(rng, style: LexStyle, klass: int) -> str:
    fk = _leak_class(rng, klass, style)
    verb = _sample_verb(rng, style, fk)
    topic = rng.choice(_TOPICS)
    parts = [verb.capitalize()]
    if rng.random() < style.code_prob[fk]:
        parts.append(rng.choice(_CODE_SNIPPETS) + " for")
    parts.append(topic)
    if rng.random() < style.format_prob[fk]:
        parts.append(rng.choice(_FORMAT_ASKS))
    if rng.random() < style.constraint_prob[fk]:
        parts.append(rng.choice(_LONG_CONSTRAINTS if fk == LONG
                                else _SHORT_CONSTRAINTS))
    n_clauses = rng.poisson(style.clause_rate[fk])
    for _ in range(min(n_clauses, 3)):
        parts.append(rng.choice(_CLAUSES))
    # pad with fillers to reach the class-dependent word-length target
    target = max(4, int(rng.normal(style.words_mean[fk], style.words_std[fk])))
    text = " ".join(parts)
    words = text.split()
    while len(words) < target:
        words.append(rng.choice(_FILLERS))
    text = " ".join(words)
    if rng.random() < style.question_prob[fk]:
        text = text + "?"
    return text


def _gen_length(rng, profile: CorpusProfile, klass: int) -> int:
    if klass == SHORT:
        return int(np.clip(rng.lognormal(3.7, 0.8), 1, 199))
    if klass == MEDIUM:
        return int(rng.integers(200, 800))
    mu = np.log(profile.response_long_mean)
    return int(np.clip(rng.lognormal(mu, 0.45), 800, 8000))


def sample_dataset(profile_name: str, n: int, seed: int = 0,
                   balanced: bool = False) -> Dataset:
    """Draw n examples from a profile (balanced => n/3 per class)."""
    profile = PROFILES[profile_name]
    rng = np.random.default_rng(seed)
    if balanced:
        per = n // 3
        classes = np.repeat(np.arange(3), per)
        n = 3 * per
    else:
        classes = rng.choice(3, size=n, p=profile.class_probs)
    prompts, lengths = [], np.zeros(n, np.int64)
    for i, k in enumerate(classes):
        prompts.append(_gen_prompt(rng, profile.style, int(k)))
        lengths[i] = _gen_length(rng, profile, int(k))
    perm = rng.permutation(n)
    return Dataset(name=profile_name,
                   prompts=[prompts[j] for j in perm],
                   lengths=lengths[perm], classes=classes[perm])
