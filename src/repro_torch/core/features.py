"""The 19 lexical features of Clairvoyant (paper §3.2) — fast-path edition.

Six numeric features + a 13-way one-hot of the leading instruction verb.

**Text normalization (the feature contract).**  All lexical features are
defined over the *normalized* prompt: lowercased, with the punctuation set
``.,:;!?"'()[]`` and every ASCII whitespace character mapped to a single
space (each punctuation char becomes one space — "short.answer" therefore
matches the "short answer" keyword, while "short, answer" normalizes to a
double space and does not).  Keyword-table features use substring
semantics on the normalized text ("tl;dr" matches via its normalized form
"tl dr").  Clause markers and the leading
verb are token-level: a token is a maximal run of non-space bytes.  This
revision also fixes the seed's clause-marker double counting: "so that" /
"such that" normalize to ``so``+``that`` / ``such``+``that`` and are
counted exactly once via their ``that`` token — the seed counted the
``that`` token *and* added a substring count of the two-word form.

**The fast path.**  ``extract_batch`` scans all prompts in one pass.  The
keyword tables *and* the clause markers are compiled once at import into a
frozen byte-level multi-pattern matcher (``_PatternMatcher``): a
65536-entry bigram-dispatch table (the flattened two-level root of an
Aho-Corasick-style trie), a per-group third-byte gate, and zero-padded
16-byte (key, mask) pairs per pattern.  At batch time the prompts are
joined into a single normalized byte corpus (separated by ``" \\x00 "`` so
no pattern can span two prompts) and matched with a handful of vectorized
numpy passes; hits are attributed to prompts by binary search over the
prompt byte offsets.  Clause-marker patterns carry their trailing space
in the key and verify the leading boundary with one gather, giving exact
token semantics without tokenizing.

``extract`` (single prompt) implements the same contract with scalar
string operations.

This module is an exact copy of ``repro.core.features`` (minus its
seed-style reference extractor): the port keeps its own copy so that it
imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

# --- keyword tables (paper lists "etc."; these are the expanded sets) -------

CODE_KEYWORDS = (
    "function", "class", "implement", "algorithm", "code", "script",
    "debug", "compile", "python", "javascript", "java", "c++", "sql",
    "api", "library", "module", "refactor", "regex", "program",
)

LENGTH_CONSTRAINT_KEYWORDS = (
    "brief", "briefly", "concise", "concisely", "short answer", "one sentence",
    "in one sentence", "in a sentence", "one word", "tl;dr", "tldr",
    "detailed", "in detail", "in-depth", "comprehensive", "thorough",
    "step by step", "step-by-step", "at length", "elaborate", "essay",
    "paragraphs", "words or less", "word limit",
)

FORMAT_KEYWORDS = (
    "table", "list", "json", "csv", "markdown", "bullet", "bullets",
    "numbered", "outline", "yaml", "xml", "html", "latex", "spreadsheet",
)

CLAUSE_MARKERS = (
    "because", "although", "though", "while", "whereas", "since", "unless",
    "that", "which", "who", "whom", "whose", "when", "where", "if", "after",
    "before", "until", "so that", "such that",
)

INSTRUCTION_VERBS = (
    "what", "write", "explain", "summarize", "how", "list", "implement",
    "compare", "describe", "generate", "why", "define",
)  # 13th category: "other"

VERB_INDEX = {v: i for i, v in enumerate(INSTRUCTION_VERBS)}
N_VERB_FEATURES = len(INSTRUCTION_VERBS) + 1  # + "other"

NUMERIC_FEATURE_NAMES = (
    "prompt_token_len",
    "has_code_keyword",
    "has_length_constraint",
    "ends_with_question",
    "has_format_keyword",
    "clause_count",
)

FEATURE_NAMES: tuple = NUMERIC_FEATURE_NAMES + tuple(
    f"verb_{v}" for v in INSTRUCTION_VERBS
) + ("verb_other",)

N_FEATURES = len(FEATURE_NAMES)
assert N_FEATURES == 19

_SYNONYMS = {
    "summarise": "summarize", "whats": "what", "what's": "what",
    "tell": "describe", "give": "generate", "create": "generate",
    "make": "generate", "show": "list", "enumerate": "list",
    "clarify": "explain", "outline": "summarize", "code": "implement",
    "build": "implement", "develop": "implement", "contrast": "compare",
}

# --- normalization tables ---------------------------------------------------

_PUNCT = ".,:;!?\"'()[]"
_WS = "\t\n\r\x0b\x0c"
_NORMALIZE_STR = str.maketrans({c: " " for c in _PUNCT + _WS})
# Byte-level variant: every translated char is ASCII, so translating the
# utf-8 corpus byte-by-byte is exact (continuation bytes are >= 0x80 and
# untouched) and runs at memcpy speed over the whole batch.
_NORMALIZE_BYTES = bytes(
    32 if chr(i) in _PUNCT + _WS else i for i in range(256))


def _normalized_table(table: Sequence[str]) -> tuple:
    out = []
    for k in table:
        t = k.translate(_NORMALIZE_STR)
        if t not in out:
            out.append(t)
    return tuple(out)


# Keyword tables in normalized space (only "tl;dr" actually changes).
NORM_CODE_KEYWORDS = _normalized_table(CODE_KEYWORDS)
NORM_LENGTH_KEYWORDS = _normalized_table(LENGTH_CONSTRAINT_KEYWORDS)
NORM_FORMAT_KEYWORDS = _normalized_table(FORMAT_KEYWORDS)

_SINGLE_CLAUSE_MARKERS = frozenset(
    m.encode() for m in CLAUSE_MARKERS if " " not in m)

# Verb lookup over normalized first tokens.  Punctuated synonyms ("what's")
# normalize to their first token before insertion.
_VERB_TOKENS_B: dict = {}
for _v, _i in VERB_INDEX.items():
    _VERB_TOKENS_B[_v.encode()] = _i
for _syn, _tgt in _SYNONYMS.items():
    _first = _syn.translate(_NORMALIZE_STR).split()[0]
    _VERB_TOKENS_B.setdefault(_first.encode(), VERB_INDEX[_tgt])
_VERB_OTHER = len(INSTRUCTION_VERBS)


# ---------------------------------------------------------------------------
# Frozen multi-pattern matcher (built once at import)
# ---------------------------------------------------------------------------

def _pack_key(b: bytes, width: int) -> int:
    """Little-endian zero-padded integer key for up to ``width`` bytes."""
    assert len(b) <= width, b
    return int.from_bytes(b.ljust(width, b"\x00"), "little")


# action ids carried per pattern
_ACT_CODE, _ACT_LENGTH, _ACT_FORMAT, _ACT_MARKER = 0, 1, 2, 3


class _PatternMatcher:
    """Single-pass vectorized multi-pattern matcher over the normalized
    corpus.

    Patterns are dispatched on their first two bytes through a 65536-entry
    group table (the flattened two-level root of an Aho-Corasick-style
    trie); a per-group 256-entry third-byte gate prunes candidates, and
    each survivor is verified with one masked uint64x2 compare of its
    16-byte window.  Groups holding several patterns (shared bigram)
    resolve their extra slots on the shrinking subset of candidates that
    reach them.  ``find`` returns (position, action) pairs for every
    pattern occurrence in the corpus.
    """

    def __init__(self, patterns: Sequence):
        groups: dict = {}
        for pid, (b, _act) in enumerate(patterns):
            assert 3 <= len(b) <= 16, b
            groups.setdefault(b[:2], []).append(pid)
        n_groups = len(groups)
        n_slots = max(len(v) for v in groups.values())
        assert n_groups < 127
        self.lut = np.full(65536, -1, np.int8)           # bigram -> group id
        self.third_ok = np.zeros((n_groups, 256), bool)  # 3rd-byte gate
        self.fourth_ok = np.zeros((n_groups, 256), bool)  # 4th-byte gate
        self.key_lo = np.zeros((n_groups, n_slots), np.uint64)
        self.key_hi = np.zeros((n_groups, n_slots), np.uint64)
        self.msk_lo = np.zeros((n_groups, n_slots), np.uint64)
        self.msk_hi = np.zeros((n_groups, n_slots), np.uint64)
        self.act = np.zeros((n_groups, n_slots), np.int8)
        self.group_size = np.zeros(n_groups, np.int16)
        for gid, (bg, pids) in enumerate(groups.items()):
            self.lut[bg[0] << 8 | bg[1]] = gid
            self.group_size[gid] = len(pids)
            for s, pid in enumerate(pids):
                b, act = patterns[pid]
                full = b.ljust(16, b"\x00")
                mask = (b"\xff" * len(b)).ljust(16, b"\x00")
                self.third_ok[gid, b[2]] = True
                if len(b) > 3:
                    self.fourth_ok[gid, b[3]] = True
                else:           # 3-byte pattern: any 4th byte may follow
                    self.fourth_ok[gid, :] = True
                self.key_lo[gid, s] = _pack_key(full[:8], 8)
                self.key_hi[gid, s] = _pack_key(full[8:], 8)
                self.msk_lo[gid, s] = _pack_key(mask[:8], 8)
                self.msk_hi[gid, s] = _pack_key(mask[8:], 8)
                self.act[gid, s] = act
        self.n_slots = n_slots

    def find(self, arr: np.ndarray):
        """All pattern occurrences in ``arr`` -> (positions, action ids).

        ``arr``: uint8 corpus padded with >= 16 trailing space bytes.
        """
        empty = np.zeros(0, np.int64), np.zeros(0, np.int8)
        scan_len = arr.shape[0] - 16
        if scan_len <= 0:
            return empty
        bg = arr[:scan_len].astype(np.uint16) << 8
        bg |= arr[1:scan_len + 1]
        gid = self.lut[bg]
        cand = np.nonzero(gid >= 0)[0]
        if cand.size == 0:
            return empty
        g = gid[cand].astype(np.intp)
        keep = self.third_ok[g, arr[cand + 2]]
        keep &= self.fourth_ok[g, arr[cand + 3]]
        cand, g = cand[keep], g[keep]
        if cand.size == 0:
            return empty
        w = np.lib.stride_tricks.sliding_window_view(arr, 16)[cand] \
            .view(np.uint64)                             # (n_cand, 2)
        w_lo, w_hi = w[:, 0], w[:, 1]
        # slot 0 (every group has one)
        bad = ((w_lo ^ self.key_lo[g, 0]) & self.msk_lo[g, 0]) \
            | ((w_hi ^ self.key_hi[g, 0]) & self.msk_hi[g, 0])
        ok = bad == 0
        hit_pos, hit_act = [cand[ok]], [self.act[g[ok], 0]]
        # remaining slots on the shrinking multi-pattern subset
        sub = np.nonzero(self.group_size[g] > 1)[0]
        for s in range(1, self.n_slots):
            if sub.size == 0:
                break
            gs = g[sub]
            bad = ((w_lo[sub] ^ self.key_lo[gs, s]) & self.msk_lo[gs, s]) \
                | ((w_hi[sub] ^ self.key_hi[gs, s]) & self.msk_hi[gs, s])
            ok = bad == 0
            hit_pos.append(cand[sub[ok]])
            hit_act.append(self.act[gs[ok], s])
            sub = sub[self.group_size[gs] > s + 1]
        return np.concatenate(hit_pos), np.concatenate(hit_act)


def _build_patterns():
    pats = []
    for table, act in ((NORM_CODE_KEYWORDS, _ACT_CODE),
                       (NORM_LENGTH_KEYWORDS, _ACT_LENGTH),
                       (NORM_FORMAT_KEYWORDS, _ACT_FORMAT)):
        for kw in table:
            pats.append((kw.encode(), act))
    # clause markers carry their trailing token boundary in the pattern;
    # the leading boundary is verified per hit
    for m in sorted(_SINGLE_CLAUSE_MARKERS):
        pats.append((m + b" ", _ACT_MARKER))
    return pats


_MATCHER = _PatternMatcher(_build_patterns())
_KW_COLUMN = np.asarray([1, 2, 4], np.int64)   # action id -> feature column


# ---------------------------------------------------------------------------
# Scalar path (same contract as the batch engine)
# ---------------------------------------------------------------------------

def _ends_with_question(prompt: str) -> bool:
    for ch in reversed(prompt):
        if not ch.isspace():
            return ch == "?"
    return False


def _contains_any(norm: str, keywords: Sequence[str]) -> float:
    return 1.0 if any(k in norm for k in keywords) else 0.0


def extract(prompt: str) -> np.ndarray:
    """19-dim float32 feature vector for one prompt."""
    norm = prompt.lower().translate(_NORMALIZE_STR)
    vec = np.zeros(N_FEATURES, dtype=np.float32)
    vec[0] = len(prompt) // 4  # BPE approximation, as in the paper
    vec[1] = _contains_any(norm, NORM_CODE_KEYWORDS)
    vec[2] = _contains_any(norm, NORM_LENGTH_KEYWORDS)
    vec[3] = 1.0 if _ends_with_question(prompt) else 0.0
    vec[4] = _contains_any(norm, NORM_FORMAT_KEYWORDS)
    verb = _VERB_OTHER
    first = True
    count = 0
    for w in norm.encode().split(b" "):
        if not w:
            continue
        if first:
            verb = _VERB_TOKENS_B.get(w, _VERB_OTHER)
            first = False
        if w in _SINGLE_CLAUSE_MARKERS:
            count += 1
    vec[5] = float(count)
    vec[6 + verb] = 1.0
    return vec


# ---------------------------------------------------------------------------
# Batched fast path
# ---------------------------------------------------------------------------

def extract_batch(prompts: Sequence[str]) -> np.ndarray:
    """(N, 19) feature matrix, one vectorized pass over all prompts."""
    n = len(prompts)
    out = np.zeros((n, N_FEATURES), dtype=np.float32)
    if n == 0:
        return out
    lows = [p.lower() for p in prompts]
    # " \x00 " separators block cross-prompt matches while keeping a space
    # boundary on both sides of every prompt; 16 trailing spaces pad the
    # 16-byte windows; 1 leading space anchors leading-boundary checks.
    joined = " " + " \x00 ".join(lows) + " " * 16
    raw = joined.encode().translate(_NORMALIZE_BYTES)
    arr = np.frombuffer(raw, np.uint8)
    if len(raw) == len(joined):       # pure-ASCII batch: byte len == char len
        lens = np.fromiter((len(l) for l in lows), np.int64, n)
    else:
        lens = np.fromiter((len(l.encode()) for l in lows), np.int64, n)
    starts = np.empty(n, np.int64)
    starts[0] = 1
    np.cumsum(lens[:-1] + 3, out=starts[1:])
    starts[1:] += 1

    # numeric scalars (one fused Python sweep; rstrip only when the last
    # char is whitespace, the rare case)
    tok_lens = [0] * n
    qidx = []
    for i, p in enumerate(prompts):
        tok_lens[i] = len(p) >> 2
        if p:
            last = p[-1]
            if last == "?" or (last.isspace()
                               and p.rstrip()[-1:] == "?"):
                qidx.append(i)
    out[:, 0] = tok_lens
    out[qidx, 3] = 1.0

    # one matcher pass: keyword bits + clause-marker counts
    pos, act = _MATCHER.find(arr)
    if pos.size:
        pid = np.searchsorted(starts, pos, side="right") - 1
        kw = act < _ACT_MARKER
        out[pid[kw], _KW_COLUMN[act[kw]]] = 1.0
        mk = np.nonzero(act == _ACT_MARKER)[0]
        mk = mk[arr[pos[mk] - 1] == 32]    # leading token boundary
        out[:, 5] = np.bincount(pid[mk], minlength=n)

    # leading verb: first normalized token per prompt.  Fast path: a
    # 16-byte peek suffices when the prompt starts with its token — every
    # verb is < 16 bytes, a prompt shorter than 16 bytes runs into its
    # separator space, and a spaceless 16-byte window means a token too
    # long to be a verb.  Leading whitespace (rare) takes the strip path.
    verbs = [_VERB_OTHER] * n
    get_verb = _VERB_TOKENS_B.get
    starts_l = starts.tolist()
    lens_l = lens.tolist()
    for i in range(n):
        s0 = starts_l[i]
        seg = raw[s0:s0 + 16]
        j = seg.find(b" ")
        if j > 0:
            verbs[i] = get_verb(seg[:j], _VERB_OTHER)
        elif j == 0:
            t = raw[s0:s0 + lens_l[i]].lstrip()
            if t:
                k = t.find(b" ")
                verbs[i] = get_verb(t[:k] if k >= 0 else t, _VERB_OTHER)
    out[np.arange(n), np.asarray(verbs, np.int64) + 6] = 1.0
    return out
