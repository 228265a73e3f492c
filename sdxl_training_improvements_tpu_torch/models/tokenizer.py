"""Offline tokenization for the dual CLIP encoders.

A copy of ``HashTokenizer``, ``TokenizerPair`` and the layout rules of
``load_tokenizers`` from ``sdxl_training_improvements_tpu/models/
tokenizer.py`` (framework-neutral; copied so the port imports nothing of
the JAX package).  The checkpoint's own CLIP BPE tokenizers wrap
``transformers``, which the card's machine lacks: where a checkpoint ships
a tokenizer directory, ``load_tokenizers`` raises instead of hashing
captions against pretrained embeddings (ROADMAP queue 1).
"""
from __future__ import annotations

import logging
import zlib
from pathlib import Path
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


def load_tokenizers(model_dir, max_length: int = 77,
                    single_encoder: bool = False,
                    fallback_vocab_size: int = 49408) -> TokenizerPair:
    """The tokenizer pair of a diffusers checkpoint directory, by JAX's
    layout rules (``models/tokenizer.py:81-134``).  ``single_encoder`` is
    the refiner layout (CLIP-G only): ``tokenizer/`` must then be absent.
    Otherwise ``tokenizer/`` and ``tokenizer_2/`` come together or not at
    all: one without the other is a partial checkpoint and raises.  With
    no tokenizer directory the hash stand-in matches the encoder's
    vocabulary (random-init checkpoints).  A present tokenizer directory
    raises: the BPE tokenizer is not ported, and hashed ids against
    pretrained CLIP weights would give images of nothing."""
    model_dir = Path(model_dir)
    dirs = [model_dir / "tokenizer", model_dir / "tokenizer_2"]
    exists = [d.exists() for d in dirs]
    if single_encoder and exists[0]:
        raise FileNotFoundError(
            f"checkpoint at {model_dir} has tokenizer/ but was detected as "
            "a single-encoder (refiner) checkpoint: layout mismatch")
    if not single_encoder and any(exists) and not all(exists):
        have, missing = (dirs[0], dirs[1]) if exists[0] else (dirs[1],
                                                               dirs[0])
        raise FileNotFoundError(
            f"checkpoint at {model_dir} has {have.name}/ but no "
            f"{missing.name}/: a partial or corrupt checkpoint. Restore "
            "both tokenizer directories (or remove both to opt into the "
            "hash-tokenizer stand-in for from-scratch runs).")
    if exists[1]:
        raise NotImplementedError(
            f"{dirs[1]}: the CLIP BPE tokenizer is not ported (it needs "
            "transformers; ROADMAP queue 1). Refusing to hash captions "
            "against this checkpoint's pretrained text encoders.")
    logging.getLogger(__name__).warning(
        "no tokenizer directory under %s - using the hash tokenizer "
        "stand-in (fine for random-init weights, WRONG for pretrained "
        "CLIP weights)", model_dir)
    return TokenizerPair.fallback(vocab_size=fallback_vocab_size,
                                  max_length=max_length)
