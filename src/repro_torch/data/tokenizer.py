"""Tokenization substrate.

A copy of ``repro.data.tokenizer``: the port imports nothing of the JAX
package.

Two pieces:
* ``approx_token_len`` — the paper's serving-side proxy (len(prompt)//4,
  §3.2); divergence for code/multilingual inputs is a documented limitation.
* ``HashTokenizer`` — a deterministic hashed word-piece tokenizer for the LM
  training pipeline (no BPE vocab files are shipped).  Maps text to
  ids in [0, vocab) via split + rolling hash, reversible enough for language-
  model training demos and fully deterministic across processes (critical for
  the data-parallel loader: every host must agree on the stream).
"""

from __future__ import annotations

import numpy as np


def approx_token_len(text: str) -> int:
    return len(text) // 4


class HashTokenizer:
    def __init__(self, vocab_size: int, seed: int = 1234567891):
        self.vocab_size = vocab_size
        self.seed = seed

    def encode(self, text: str) -> np.ndarray:
        ids = []
        for word in text.split():
            h = self.seed
            for ch in word:
                h = (h * 1000003 ^ ord(ch)) & 0x7FFFFFFF
            ids.append(h % self.vocab_size)
        return np.asarray(ids, np.int32)

    def encode_batch(self, texts, pad_to: int) -> np.ndarray:
        out = np.zeros((len(texts), pad_to), np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t)[:pad_to]
            out[i, : len(ids)] = ids
        return out
