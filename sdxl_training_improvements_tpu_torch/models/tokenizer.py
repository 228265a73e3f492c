"""Offline tokenization for the dual CLIP encoders.

A copy of ``HashTokenizer`` and ``TokenizerPair`` from
``sdxl_training_improvements_tpu/models/tokenizer.py`` (framework-neutral;
copied so the port imports nothing of the JAX package).  Loading the
checkpoint's own CLIP tokenizers waits until the port loads checkpoints.
"""
from __future__ import annotations

import zlib
from typing import Sequence, Tuple

import numpy as np


class HashTokenizer:
    """Deterministic stand-in with CLIP's special-token layout: BOS first,
    EOS after the last token and as padding, EOS the highest id so argmax
    pooling finds the true EOS."""

    def __init__(self, vocab_size: int = 49408, max_length: int = 77):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos_id = vocab_size - 2
        self.eos_id = vocab_size - 1

    def __call__(self, captions: Sequence[str]) -> np.ndarray:
        out = np.full((len(captions), self.max_length), self.eos_id,
                      dtype=np.int32)
        for b, caption in enumerate(captions):
            ids = [self.bos_id]
            for tok in caption.lower().split():
                # crc32 is stable across processes (hash() is salted)
                ids.append(zlib.crc32(tok.encode()) % (self.vocab_size - 3))
                if len(ids) >= self.max_length - 1:
                    break
            ids.append(self.eos_id)
            out[b, :len(ids)] = ids
        return out


class TokenizerPair:
    """(tokenizer, tokenizer_2) -> (ids_l, ids_g), [B, 77] each."""

    def __init__(self, tok_l, tok_g):
        self.tok_l = tok_l
        self.tok_g = tok_g

    def __call__(self, captions: Sequence[str]
                 ) -> Tuple[np.ndarray, np.ndarray]:
        return self.tok_l(captions), self.tok_g(captions)

    @classmethod
    def fallback(cls, vocab_size: int = 49408, max_length: int = 77
                 ) -> "TokenizerPair":
        t = HashTokenizer(vocab_size, max_length)
        return cls(t, t)
