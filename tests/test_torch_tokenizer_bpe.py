"""PyTorch port: the CLIP BPE tokenizer against ``transformers``.

The test writes its own tokenizer directories: a ``vocab.json`` of the
512 byte symbols (each with and without ``</w>``), the results of 50
merges learned from a small corpus and the two special tokens; a
``merges.txt`` with its version line; and the special-token files in the
layout SDXL checkpoints ship, ``tokenizer/`` padding with
``<|endoftext|>`` and ``tokenizer_2/`` with ``"!"`` (id 0).  The port's
``CLIPBPETokenizer`` must give the ids of ``CLIPTokenizerFast`` built from
the same files, for every caption below; the port's ``load_tokenizers`` on
a checkpoint directory the ids of the JAX package's, in the base and the
refiner layout, with JAX's layout errors.
"""
import collections
import json

import numpy as np
import pytest

transformers = pytest.importorskip("transformers")

from sdxl_training_improvements_tpu.models.tokenizer import (  # noqa: E402
    load_tokenizers as jax_load_tokenizers)
from sdxl_training_improvements_tpu_torch.models import (  # noqa: E402
    tokenizer as T)

CORPUS = ("the cat sat on the mat a photograph of an astronaut riding a "
          "horse that there then cats hat it's don't they're oil painting "
          "lighthouse at dawn 1024 pixels").split()
N_MERGES = 50
CAPTIONS = [
    "a photograph of an astronaut riding a horse",     # ASCII
    "It's the cat's hat, isn't it? They're here; we'll see, I'd go",
    "1024 x 768 pixels, 3.14159 and 2024",               # digits
    "wow!!! ... ?!?! (((masterpiece))) --ar 16:9 ~~~",   # punctuation runs
    "  the   cat\tsat\n\non  the mat  ",               # whitespace
    "café naïve Ångström ΣΑΣ İstanbul",                  # accents, case
    "é combining acute",                           # NFC
    "東京タワーの夜景 猫",                                   # CJK
    "🐱🎉 emoji 👩‍🚀 party",                                # emoji
    "",                                                  # empty
    " ".join(["the astronaut riding a horse"] * 20),    # past 77 tokens
    "a <|endoftext|> b <|startoftext|>!",               # special tokens
]


def _learn_merges(byte_char):
    """BPE training on ``CORPUS``: the most frequent pair, N_MERGES
    times."""
    def symbols(w):
        s = "".join(byte_char[b] for b in w.encode())
        return tuple(s[:-1]) + (s[-1] + "</w>",)

    words = collections.Counter(symbols(w) for w in CORPUS)
    merges = []
    for _ in range(N_MERGES):
        pairs = collections.Counter()
        for w, c in words.items():
            for p in zip(w, w[1:]):
                pairs[p] += c
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        merged = collections.Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if w[i:i + 2] == best:
                    out.append(best[0] + best[1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
    return merges


def _token(content):
    return {"content": content, "lstrip": False, "normalized": True,
            "rstrip": False, "single_word": False}


def write_tokenizer(d, pad):
    """A tokenizer directory in SDXL's layout padding with ``pad``; returns
    the vocabulary."""
    byte_char = T._bytes_to_unicode()
    syms = list(byte_char.values())  # CLIP's order: "!" is id 0
    vocab = {}
    for s in syms + [s + "</w>" for s in syms]:
        vocab[s] = len(vocab)
    merges = _learn_merges(byte_char)
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    for s in ("<|startoftext|>", "<|endoftext|>"):
        vocab[s] = len(vocab)
    d.mkdir(parents=True)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    special = {"bos_token": _token("<|startoftext|>"),
               "eos_token": _token("<|endoftext|>"),
               "unk_token": _token("<|endoftext|>"), "pad_token": pad}
    (d / "special_tokens_map.json").write_text(json.dumps(special))
    config = {k: dict(v, __type="AddedToken") if isinstance(v, dict) else v
              for k, v in special.items()}
    config.update(add_prefix_space=False, do_lower_case=True,
                  errors="replace", model_max_length=77,
                  tokenizer_class="CLIPTokenizer")
    (d / "tokenizer_config.json").write_text(json.dumps(config))
    return vocab


PADS = {"tokenizer": "<|endoftext|>", "tokenizer_2": "!"}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    for name, pad in PADS.items():
        write_tokenizer(root / name, pad)
    return root


def _reference(d):
    tok = transformers.CLIPTokenizerFast.from_pretrained(str(d))
    return np.asarray(tok(CAPTIONS, padding="max_length", max_length=77,
                          truncation=True)["input_ids"], np.int32)


@pytest.mark.parametrize("name", sorted(PADS))
def test_ids_match_clip_tokenizer_fast(checkpoint, name):
    ids = T.CLIPBPETokenizer.from_dir(checkpoint / name)(CAPTIONS)
    ref = _reference(checkpoint / name)
    assert ids.dtype == np.int32 and ids.shape == (len(CAPTIONS), 77)
    for caption, a, b in zip(CAPTIONS, ids, ref):
        np.testing.assert_array_equal(a, b, err_msg=repr(caption))
    vocab = json.loads((checkpoint / name / "vocab.json").read_text())
    pad_id = vocab[PADS[name]]
    assert pad_id == (0 if name == "tokenizer_2" else vocab["<|endoftext|>"])
    # the empty caption: bos, eos, then the directory's own pad
    assert ids[CAPTIONS.index("")][:3].tolist() == [
        vocab["<|startoftext|>"], vocab["<|endoftext|>"], pad_id]
    # past 77 tokens: truncated with eos kept last
    long = ids[CAPTIONS.index(CAPTIONS[10])]
    assert long[-1] == vocab["<|endoftext|>"] and pad_id not in long[1:-1]


def test_directory_saved_by_transformers(checkpoint, tmp_path):
    """``save_pretrained`` writes ``added_tokens_decoder`` into the config
    (and a ``tokenizer.json`` the port ignores): the same ids."""
    for name in PADS:
        tok = transformers.CLIPTokenizerFast.from_pretrained(
            str(checkpoint / name))
        tok.save_pretrained(str(tmp_path / name))
        config = json.loads((tmp_path / name /
                             "tokenizer_config.json").read_text())
        assert "added_tokens_decoder" in config
        np.testing.assert_array_equal(
            T.CLIPBPETokenizer.from_dir(tmp_path / name)(CAPTIONS),
            _reference(tmp_path / name))


def test_load_tokenizers_matches_jax(checkpoint, tmp_path):
    pair = T.load_tokenizers(checkpoint)
    jpair = jax_load_tokenizers(checkpoint)
    for a, b in zip(pair(CAPTIONS), jpair(CAPTIONS)):
        np.testing.assert_array_equal(a, b)
    # the refiner layout: tokenizer_2/ alone fills both slots
    refiner = tmp_path / "refiner"
    write_tokenizer(refiner / "tokenizer_2", "!")
    pair = T.load_tokenizers(refiner, single_encoder=True)
    jpair = jax_load_tokenizers(refiner, single_encoder=True)
    assert pair.tok_l is pair.tok_g
    for a, b in zip(pair(CAPTIONS), jpair(CAPTIONS)):
        np.testing.assert_array_equal(a, b)
    # JAX's layout errors
    for kw in ({"single_encoder": True}, {}):
        root = checkpoint if kw else refiner
        with pytest.raises(FileNotFoundError):
            T.load_tokenizers(root, **kw)
        with pytest.raises(FileNotFoundError):
            jax_load_tokenizers(root, **kw)


def test_refusals(tmp_path):
    d = tmp_path / "tokenizer"
    write_tokenizer(d, "<|endoftext|>")
    (d / "merges.txt").unlink()
    with pytest.raises(FileNotFoundError, match="merges.txt"):
        T.CLIPBPETokenizer.from_dir(d)
    d = tmp_path / "tokenizer_2"
    write_tokenizer(d, "<pad>")
    with pytest.raises(ValueError, match="not in vocab.json"):
        T.CLIPBPETokenizer.from_dir(d)
