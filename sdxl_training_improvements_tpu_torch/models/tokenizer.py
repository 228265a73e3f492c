"""Tokenization for the dual CLIP encoders, with no ``transformers``.

``CLIPBPETokenizer`` reads a checkpoint's tokenizer directory
(``vocab.json``, ``merges.txt``, ``special_tokens_map.json``,
``tokenizer_config.json``) and gives the ids that ``CLIPTokenizerFast(...)
(captions, padding="max_length", max_length=77, truncation=True)`` gives,
which is what the JAX package's ``load_tokenizers`` wraps:

* special tokens written in a caption are matched first, leftmost-longest:
  those whose ``normalized`` flag is false (a special token given as a bare
  string, such as SDXL ``tokenizer_2/``'s ``"!"`` pad) in the raw text,
  the others in the normalized text;
* normalization: NFC, every whitespace run to one space, lowercase;
* CLIP's split, ``'s|'t|'re|'ve|'m|'ll|'d|\\p{L}+|\\p{N}|[^\\s\\p{L}\\p{N}]+``
  with whitespace dropped, where letters and numbers are the ``unicodedata``
  categories L* and N* (the card's machine has no ``regex``);
* each piece's UTF-8 bytes mapped to GPT-2's byte alphabet and merged by
  BPE in rank order, ``</w>`` on the piece's last symbol; ``merges.txt``
  is read as the slow ``CLIPTokenizer`` reads it (its first line skipped,
  at most 48,894 merges);
* bos first, eos last after truncation to ``max_length``, then the
  directory's own pad token: ``tokenizer/`` pads with ``<|endoftext|>``,
  SDXL's ``tokenizer_2/`` with ``"!"`` (id 0).

``load_tokenizers`` applies the layout rules of ``sdxl_training_
improvements_tpu/models/tokenizer.py``; ``HashTokenizer`` (a copy of
JAX's) stands in only for checkpoints with no tokenizer directory.
"""
from __future__ import annotations

import json
import logging
import unicodedata
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# the slow CLIPTokenizer reads at most this many merges (49152 - 256 - 2)
_MAX_MERGES = 48894
_END_OF_WORD = "</w>"
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# Unicode White_Space, what the fast tokenizer's \s matches
_SPACES = frozenset("\t\n\x0b\x0c\r\x85")
_SPECIAL = ("bos_token", "eos_token", "pad_token", "unk_token")


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte alphabet: printable bytes stand for themselves, the
    others for the code points from 256 up."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    out, n = {b: chr(b) for b in keep}, 0
    for b in range(256):
        if b not in out:
            out[b] = chr(256 + n)
            n += 1
    return out


_BYTE_CHARS = _bytes_to_unicode()


def _kind(ch: str) -> str:
    """'S' whitespace, 'L' letter, 'N' number, 'P' anything else."""
    if ch in _SPACES:
        return "S"
    cat = unicodedata.category(ch)
    if cat in ("Zs", "Zl", "Zp"):
        return "S"
    return cat[0] if cat[0] in "LN" else "P"


def _normalize(text: str) -> str:
    """NFC, each whitespace run to one space, lowercase (each character
    on its own, as the fast tokenizer does: a final capital sigma becomes
    σ, not ς)."""
    text = unicodedata.normalize("NFC", text)
    out, space = [], False
    for ch in text:
        if _kind(ch) == "S":
            if not space:
                out.append(" ")
            space = True
        else:
            out.append(ch.lower())
            space = False
    return "".join(out)


def _split_words(text: str) -> List[str]:
    """CLIP's pattern, leftmost first, over normalized text: a contraction,
    a run of letters, one number, or a run of anything but whitespace,
    letters and numbers; whitespace is dropped."""
    out, i, n = [], 0, len(text)
    while i < n:
        c = next((c for c in _CONTRACTIONS if text.startswith(c, i)), None)
        if c is not None:
            out.append(c)
            i += len(c)
            continue
        kind = _kind(text[i])
        j = i + 1
        if kind == "S":
            i = j
            continue
        if kind != "N":
            while j < n and _kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


def _token_content(value) -> Tuple[Optional[str], bool]:
    """(content, normalized) of a special token as the tokenizer files
    write it: a bare string (a special token, matched in the raw text) or
    an AddedToken dict."""
    if value is None:
        return None, False
    if isinstance(value, str):
        return value, False
    return value["content"], bool(value.get("normalized", False))


class CLIPBPETokenizer:
    """One CLIP BPE tokenizer (module docstring); ``__call__`` maps
    captions to int32 ids [B, max_length]."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str,
                                                                    str]],
                 bos: str, eos: str, pad: str, unk: Optional[str] = None,
                 added: Optional[Dict[str, Tuple[int, bool]]] = None,
                 max_length: int = 77):
        self.vocab = vocab
        self.ranks = {tuple(m): r for r, m in enumerate(merges)}
        self.max_length = max_length
        # content -> (id, normalized) of each special token
        self.added = dict(added or {})
        for tok in (bos, eos, pad, unk):
            if tok is not None and tok not in self.added:
                self.added[tok] = (self._id(tok), False)
        self.bos_id, self.eos_id = self._id(bos), self._id(eos)
        self.pad_id = self._id(pad)
        self.unk_id = None if unk is None else self._id(unk)

    def _id(self, tok: str) -> int:
        if tok in self.added:
            return self.added[tok][0]
        if tok in self.vocab:
            return self.vocab[tok]
        raise ValueError(f"token {tok!r} is not in the vocabulary")

    @classmethod
    def from_dir(cls, d, max_length: int = 77) -> "CLIPBPETokenizer":
        """A checkpoint's tokenizer directory; a missing file raises,
        naming it."""
        d = Path(d)
        for name in ("vocab.json", "merges.txt"):
            if not (d / name).exists():
                raise FileNotFoundError(f"{d / name}: the tokenizer "
                                        "directory lacks its " + name)
        vocab = json.loads((d / "vocab.json").read_text(encoding="utf-8"))
        lines = (d / "merges.txt").read_text(
            encoding="utf-8").strip().split("\n")[1:_MAX_MERGES + 1]
        merges = [tuple(line.split()) for line in lines]
        config, smap = (json.loads(p.read_text(encoding="utf-8"))
                        if p.exists() else {}
                        for p in (d / "tokenizer_config.json",
                                  d / "special_tokens_map.json"))
        # special_tokens_map.json overrides the config, as in transformers
        special = {k: src[k] for src in (config, smap) for k in _SPECIAL
                   if src.get(k) is not None}
        added = {tok["content"]: (int(i), bool(tok.get("normalized", False)))
                 for i, tok in (config.get("added_tokens_decoder")
                                or {}).items()}
        names = {}
        for key in _SPECIAL:
            content, normed = _token_content(special.get(key))
            names[key] = content
            if content is None or content in added:
                continue
            if content not in vocab:
                raise ValueError(f"{d}: {key} {content!r} is not in "
                                 "vocab.json")
            added[content] = (vocab[content], normed)
        if not names["bos_token"] or not names["eos_token"]:
            raise ValueError(f"{d}: no bos_token or eos_token in "
                             "special_tokens_map.json or "
                             "tokenizer_config.json")
        return cls(vocab, merges, names["bos_token"], names["eos_token"],
                   names["pad_token"] or names["eos_token"],
                   names["unk_token"], added, max_length)

    def _bpe(self, piece: str) -> List[int]:
        """One pre-token's ids: its bytes in GPT-2's alphabet, merged by
        rank (every occurrence of the best pair, left to right)."""
        chars = "".join(_BYTE_CHARS[b] for b in piece.encode("utf-8"))
        word = list(chars[:-1]) + [chars[-1] + _END_OF_WORD]
        while len(word) > 1:
            best = min(zip(word, word[1:]),
                       key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == best[0]
                        and word[i + 1] == best[1]):
                    merged.append(best[0] + best[1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        ids = []
        for sym in word:
            if sym in self.vocab:
                ids.append(self.vocab[sym])
            elif self.unk_id is not None:
                ids.append(self.unk_id)
            else:
                raise ValueError(f"symbol {sym!r} is not in the vocabulary "
                                 "and the tokenizer has no unk token")
        return ids

    def _split_added(self, text: str, normalized: bool) -> List[object]:
        """``text`` as a list of strings and special-token ids: the special
        tokens of this ``normalized`` flag matched leftmost-longest."""
        toks = sorted((t for t, (_, n) in self.added.items()
                       if n == normalized), key=len, reverse=True)
        out: List[object] = []
        i = 0
        while toks:
            best = None
            for t in toks:  # longest first: ties at a start keep it
                j = text.find(t, i)
                if j >= 0 and (best is None or j < best[0]):
                    best = (j, t)
            if best is None:
                break
            j, t = best
            if j > i:
                out.append(text[i:j])
            out.append(self.added[t][0])
            i = j + len(t)
        if i < len(text) or not out:
            out.append(text[i:])
        return out

    def encode(self, text: str) -> List[int]:
        """A caption's ids, without bos, eos or padding."""
        ids: List[int] = []
        for part in self._split_added(text, normalized=False):
            if isinstance(part, int):
                ids.append(part)
                continue
            for sub in self._split_added(_normalize(part), normalized=True):
                if isinstance(sub, int):
                    ids.append(sub)
                    continue
                for word in _split_words(sub):
                    ids.extend(self._bpe(word))
        return ids

    def __call__(self, captions: Sequence[str]) -> np.ndarray:
        out = np.full((len(captions), self.max_length), self.pad_id,
                      dtype=np.int32)
        for b, caption in enumerate(captions):
            ids = ([self.bos_id] + self.encode(caption)[:self.max_length - 2]
                   + [self.eos_id])
            out[b, :len(ids)] = ids
        return out


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
    the refiner layout (CLIP-G only): ``tokenizer/`` must then be absent,
    and ``tokenizer_2/`` fills both slots.  Otherwise ``tokenizer/`` and
    ``tokenizer_2/`` come together or not at all: one without the other is
    a partial checkpoint and raises.  With no tokenizer directory the hash
    stand-in matches the encoder's vocabulary (random-init checkpoints:
    wrong for pretrained CLIP weights, which is logged)."""
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
        tok_g = CLIPBPETokenizer.from_dir(dirs[1], max_length)
        if single_encoder:
            return TokenizerPair(tok_g, tok_g)
        return TokenizerPair(CLIPBPETokenizer.from_dir(dirs[0], max_length),
                             tok_g)
    logging.getLogger(__name__).warning(
        "no tokenizer directory under %s - using the hash tokenizer "
        "stand-in (fine for random-init weights, WRONG for pretrained "
        "CLIP weights)", model_dir)
    return TokenizerPair.fallback(vocab_size=fallback_vocab_size,
                                  max_length=max_length)
