"""PyTorch port: WebP in the image reader (``images.py``,
``native/webp_decode.cpp``) against Pillow 12.1.0's libwebp and the JAX
package.

* Every committed WebP fixture (``tools/make_image_fixtures.py``) reads
  as its manifest says and as live Pillow decodes it: ``read_rgb``,
  ``read_gray``, ``read_image_size`` and, where Pillow shows one, the
  alpha plane (``np.array_equal``); the fixtures reach every part of the
  decoder (each VP8L transform, palettes of 2, 4, 16 and 256 colors, the
  color cache, an entropy image; the simple and normal loop filters,
  sharpness 1-7, 2, 4 and 8 token partitions, segments on and off, skip
  flags; each ALPH method and filter; an offset first frame of an
  animation; a segment map without its data, with its tree
  probabilities written and at their defaults).
* Files Pillow's own ``save`` writes from seeded arrays at 1x1 and sizes
  that are not multiples of 16 read as Pillow reads them: lossy over
  quality, method and alpha, lossless over quality, method, alpha and
  ``exact``, and animations whose first frame Pillow's encoder crops.
* Damaged files: where Pillow refuses one, the port raises ``ValueError``
  naming it; where Pillow decodes one, the port gives its pixels.
  Hand-written VP8L streams libwebp's encoder never writes: a palette
  index past the palette (zero), predictor modes 14 and 15, and the codes
  libwebp refuses (incomplete or over-subscribed, a length run past the
  alphabet, a repeated transform, a bad color cache, a back reference
  before the first pixel).
* The precompute over a folder of WebP, JPEG and PNG files writes the
  JAX package's buckets and cache, bit for bit; ``generate.py``'s
  ``--init`` and ``--mask`` from WebP files equal JAX's.
* More threads than cores decoding at once from a cold build directory
  build once and give the serial result.
"""
import hashlib
import json
import os
import struct
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from sdxl_training_improvements_tpu import generate as jax_generate
from sdxl_training_improvements_tpu import native as jax_native
from sdxl_training_improvements_tpu.config import Config as JConfig
from sdxl_training_improvements_tpu.data import cache as JCa
from sdxl_training_improvements_tpu.data import dataset as JD
from sdxl_training_improvements_tpu_torch import generate, images, native
from sdxl_training_improvements_tpu_torch.config import Config as TConfig
from sdxl_training_improvements_tpu_torch.data import cache as TCa
from sdxl_training_improvements_tpu_torch.data import dataset as TD
from tools.make_image_fixtures import _BoolDecoder, _chunks

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"
SIZES = [(1, 1), (15, 17), (33, 65), (130, 9)]


def _manifest() -> dict:
    return json.loads((FIXTURES / "manifest.json").read_text())


WEBP_FIXTURES = sorted(n for n in _manifest()["files"] if n.endswith(".webp"))


def _pixels(w: int, h: int, channels: int, seed: int) -> np.ndarray:
    """Seeded gradients with noise (alpha, when asked for, too)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * (k + 1) + y * (3 - k)) * 200 // (4 * (w + h))
                     + 20 * k for k in range(channels)], -1)
    return np.clip(base + rng.integers(-24, 25, base.shape), 0, 255
                   ).astype(np.uint8)


def _pillow(path):
    """Pillow's (RGB, L, alpha, size) of ``path``; alpha None where Pillow
    shows none (mode RGB: the file says it has no alpha)."""
    with Image.open(path) as im:
        alpha = (np.asarray(im)[..., 3] if im.mode == "RGBA" else None)
        return (np.asarray(im.convert("RGB")), np.asarray(im.convert("L")),
                alpha, im.size)


def _assert_reads_as_pillow(path) -> None:
    rgb, gray, alpha, size = _pillow(path)
    assert images.read_image_size(path) == size
    assert np.array_equal(images.read_rgb(path), rgb), path
    assert np.array_equal(images.read_gray(path), gray), path
    if alpha is not None:
        assert np.array_equal(
            images.read_webp(path, Path(path).read_bytes())[1], alpha), path


def _save(path, a: np.ndarray, **kw) -> None:
    Image.fromarray(a, "RGBA" if a.shape[-1] == 4 else "RGB").save(
        path, "WEBP", **kw)


# ------------------------------------------------------------ fixtures
@pytest.mark.parametrize("name", WEBP_FIXTURES)
def test_webp_fixtures_match_manifest(name):
    """The manifest is Pillow's decode of the committed bytes, and the
    port's decode is the manifest (alpha against Pillow's too)."""
    entry = _manifest()["files"][name]
    path = FIXTURES / name
    rgb, gray, alpha, size = _pillow(path)
    want = (entry["rgb_sha256"], entry["l_sha256"])
    assert list(size) == entry["size"]
    assert (hashlib.sha256(rgb.tobytes()).hexdigest(),
            hashlib.sha256(gray.tobytes()).hexdigest()) == want
    assert list(images.read_image_size(path)) == entry["size"]
    got_rgb, got_alpha = images.read_webp(path, path.read_bytes())
    assert (hashlib.sha256(got_rgb.tobytes()).hexdigest(),
            hashlib.sha256(images.read_gray(path).tobytes()).hexdigest()
            ) == want
    assert alpha is None or np.array_equal(got_alpha, alpha)


def test_webp_fixtures_reach_every_part_of_the_decoder():
    infos = {}
    for name in WEBP_FIXTURES:
        path = FIXTURES / name
        infos[name] = info = {}
        images.read_webp(path, path.read_bytes(), info)
    lossless = [i for i in infos.values() if i["lossless"]]
    lossy = [i for i in infos.values() if not i["lossless"]]
    assert any(i["transforms"] == 0b0111 for i in lossless)  # all three
    assert {2, 4, 16, 256} <= {i["palette"] for i in lossless}
    assert any(i["cache_bits"] for i in lossless)
    assert any(i["entropy_image"] for i in lossless)
    assert {0, 1, 2} <= {i["filter_type"] for i in lossy}
    assert set(range(8)) <= {i["sharpness"] for i in lossy}
    assert {1, 2, 4, 8} <= {i["partitions"] for i in lossy}
    assert {0, 1} <= {i["segments"] for i in lossy}
    assert any(i["skip_flags"] for i in lossy)
    assert any(i["bpred_mbs"] for i in lossy)
    assert {(m, f) for m in (1, 2) for f in range(4)} <= {
        (i["alpha_method"], i["alpha_filter"]) for i in lossy}
    name = "w_animated_offset.webp"
    blob = (FIXTURES / name).read_bytes()
    lay = images.webp_layout(name, lambda o, n: blob[o:o + n], len(blob))
    assert lay.offset != (0, 0) and lay.size != lay.canvas
    rgb = images.read_rgb(FIXTURES / name)
    x, y = lay.offset
    assert not rgb[:y].any() and not rgb[:, :x].any()  # (0, 0, 0) there


@pytest.mark.parametrize("name,written", [
    ("w_vp8_segment_map_tree_probs.webp", True),
    ("w_vp8_segment_map_default_probs.webp", False)])
def test_vp8_segment_map_without_its_data_as_pillow(name, written):
    """The hand-assembled key frames whose segment header updates the map
    and not the data (``tools/make_image_fixtures.py`` ``vp8_map_only``;
    libwebp's encoder writes both or neither): the header says so, with
    the map's tree probabilities written or left at 255, the decoder
    reads the map, and the decode is Pillow's."""
    path = FIXTURES / name
    blob = path.read_bytes()
    frame = _chunks(blob)[b"VP8 "]
    size0 = int.from_bytes(frame[:3], "little") >> 5
    dec = _BoolDecoder(frame[10:10 + size0])
    # color space, clamping; segments on, map updated, data not
    assert [dec.get(128) for _ in range(5)][2:] == [1, 1, 0]
    flags = []
    for _ in range(3):
        flags.append(dec.get(128))
        if flags[-1]:
            [dec.get(128) for _ in range(8)]
    assert flags == [int(written)] * 3
    info = {}
    rgb, _ = images.read_webp(path, blob, info)
    assert info["segments"] == info["segment_map"] == 1
    with Image.open(path) as im:
        assert np.array_equal(rgb, np.asarray(im.convert("RGB")))
        assert np.array_equal(images.read_gray(path),
                              np.asarray(im.convert("L")))


def test_entry_fixtures_are_phase_11s():
    """chip_smoke.py's phase 11 trains on these two at its bucket sizes."""
    assert images.read_image_size(FIXTURES / "entry_lossy_alpha.webp") == (
        1024, 1024)
    assert images.read_image_size(FIXTURES / "entry_lossless.webp") == (
        1216, 832)
    total = sum(e["bytes"] for n, e in _manifest()["files"].items()
                if n.endswith(".webp"))
    assert total < 1 << 20


# ---------------------------------------------------- Pillow's own save
@pytest.mark.parametrize("quality,method,alpha", [
    (q, m, a) for q in (5, 50, 90, 100) for m in (0, 4, 6)
    for a in (False, True)])
def test_lossy_round_trip(tmp_path, quality, method, alpha):
    for i, (w, h) in enumerate(SIZES):
        path = tmp_path / f"{i}.webp"
        _save(path, _pixels(w, h, 4 if alpha else 3, 100 * quality + w),
              quality=quality, method=method)
        _assert_reads_as_pillow(path)


@pytest.mark.parametrize("quality,method,exact,alpha", [
    (q, m, e, a) for q, m in ((0, 0), (50, 3), (100, 6))
    for e in (False, True) for a in (False, True)])
def test_lossless_round_trip(tmp_path, quality, method, exact, alpha):
    for i, (w, h) in enumerate(SIZES):
        a = _pixels(w, h, 4 if alpha else 3, 7 * quality + h)
        if alpha:
            a[::2, ::3, 3] = 0  # transparent pixels ``exact`` keeps
        path = tmp_path / f"{i}.webp"
        _save(path, a, lossless=True, quality=quality, method=method,
              exact=exact)
        _assert_reads_as_pillow(path)


@pytest.mark.parametrize("lossless", [False, True])
def test_animation_first_frame_cropped_by_pillow(tmp_path, lossless):
    """Pillow's animation encoder crops a first frame with transparent
    borders to its opaque rectangle, at an offset on the canvas."""
    rng = np.random.default_rng(3)
    f1 = np.zeros((60, 70, 4), np.uint8)
    f1[10:40, 12:50] = rng.integers(0, 256, (30, 38, 4))
    f1[10:40, 12:50, 3] = 255
    f2 = _pixels(70, 60, 4, 4)
    path = tmp_path / "anim.webp"
    Image.fromarray(f1).save(path, "WEBP", save_all=True, lossless=lossless,
                             append_images=[Image.fromarray(f2)],
                             duration=100, quality=80)
    blob = path.read_bytes()
    lay = images.webp_layout(path, lambda o, n: blob[o:o + n], len(blob))
    assert lay.offset == (12, 10) and lay.size == (38, 30)
    _assert_reads_as_pillow(path)


# ------------------------------------------------------- damaged files
def _pillow_refuses(path) -> bool:
    try:
        with Image.open(path) as im:
            im.convert("RGB")
    except (OSError, SyntaxError, ValueError):
        return True
    return False


def _pillow_opens(path) -> bool:
    try:
        with Image.open(path):
            return True
    except (OSError, SyntaxError, ValueError):
        return False


def _le32(v: int) -> bytes:
    return struct.pack("<I", v)


def _vp8x(flags: int, w: int, h: int) -> bytes:
    return (b"VP8X" + _le32(10) + bytes([flags, 0, 0, 0]) +
            (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little"))


def _named_damage() -> dict:
    """name -> (a damaged WebP that Pillow refuses, the port's reason)."""
    lossy = (FIXTURES / "w_lossy_64x48_q75_m4.webp").read_bytes()
    ll = (FIXTURES / "w_lossless_57x43_q100_m6.webp").read_bytes()
    raw = (FIXTURES / "w_alph_raw_none.webp").read_bytes()
    anim = (FIXTURES / "w_animated_offset.webp").read_bytes()
    alph = raw.index(b"ALPH")
    anmf = anim.index(b"ANMF")
    vp8l = ll[ll.index(b"VP8L"):]
    out = {
        "RIFF size past the end": (
            lossy[:4] + _le32(len(lossy)) + lossy[8:], "truncated file"),
        "chunk past the RIFF chunk": (
            lossy[:16] + _le32(len(lossy)) + lossy[20:],
            "runs past the RIFF chunk"),
        "VP8 start code": (lossy[:23] + b"\x9c" + lossy[24:], "start code"),
        "VP8 partition 0 past its chunk": (lossy[:20] + bytes(
            [lossy[20] | 0xE0, 0xFF, 0xFF]) + lossy[23:],
            "corrupt VP8 frame header"),
        "VP8L signature": (ll[:20] + b"\x2e" + ll[21:],
                           "corrupt VP8L header"),
        "VP8L version": (ll[:24] + bytes([ll[24] | 0x20]) + ll[25:],
                         "corrupt VP8L header"),
        "reserved VP8X flags": (raw[:20] + bytes([raw[20] | 1]) + raw[21:],
                                "reserved VP8X flags"),
        "ALPH header reserved bits": (raw[:alph + 8] + bytes(
            [raw[alph + 8] | 0xC0]) + raw[alph + 9:], "ALPH header"),
        "ALPH before VP8L": (b"RIFF" + _le32(4 + 18 + 10 + len(vp8l)) +
                             b"WEBP" + _vp8x(0x10, 57, 43) + b"ALPH" +
                             _le32(2) + b"\x00\x00" + vp8l,
                             "ALPH chunk before a VP8L"),
        "frame off its canvas": (anim[:anmf + 8] + bytes([0xFF]) +
                                 anim[anmf + 9:], "off the 40x30 canvas"),
        "still frame smaller than its canvas": (raw[:24] + bytes(
            [raw[24] + 2]) + raw[25:], "the canvas 41x23"),
        "animation without a frame": (
            b"RIFF" + _le32(4 + 18 + 14) + b"WEBP" + anim[12:30] + b"ANIM"
            + _le32(6) + bytes(6), "no image"),
        "nothing after VP8X": (b"RIFF" + _le32(4 + 18) + b"WEBP" +
                               raw[12:30], "nothing after VP8X"),
    }
    # the ALPH payload shorter than the plane: sizes kept consistent
    n = struct.unpack("<I", raw[alph + 4:alph + 8])[0]
    cut = raw[:alph + 4] + _le32(n - 40) + raw[alph + 8:alph + 8 + n - 40] \
        + raw[alph + 8 + n + (n & 1):]
    out["raw ALPH too short"] = (cut[:4] + _le32(len(cut) - 8) + cut[8:],
                                 "truncated alpha data")
    return out


@pytest.mark.parametrize("what", sorted(_named_damage()))
def test_damaged_webp_refused_naming_the_file(tmp_path, what):
    path = tmp_path / "damaged.webp"
    blob, reason = _named_damage()[what]
    path.write_bytes(blob)
    assert _pillow_refuses(path), what
    for read in (images.read_rgb, images.read_gray):
        with pytest.raises(ValueError, match=f"damaged.webp: .*{reason}"):
            read(path)
    if not _pillow_opens(path):
        with pytest.raises(ValueError, match=f"damaged.webp: .*{reason}"):
            images.read_image_size(path)


@pytest.mark.parametrize("source", [
    "w_lossy_37x21_q30_m0.webp", "w_vp8_partitions4.webp",
    "w_alph_lossless_gradient.webp", "w_alph_raw_vertical.webp",
    "w_lossless_96x80_q50_m3.webp", "w_lossless_16colors.webp",
    "w_animated_offset.webp"])
def test_truncated_and_corrupt_webp_as_pillow(tmp_path, source):
    """Cuts and seeded bit flips: refused where Pillow refuses them (the
    size too, where Pillow cannot open the file), Pillow's pixels where
    it decodes them."""
    blob = (FIXTURES / source).read_bytes()
    rng = np.random.default_rng(len(blob))
    variants = [blob[:n] for n in sorted({13, 21, 30, len(blob) // 2,
                                          len(blob) - 2, len(blob) - 1})]
    for _ in range(40):
        b = bytearray(blob)
        b[int(rng.integers(12, len(b)))] ^= 1 << int(rng.integers(8))
        variants.append(bytes(b))
    refused = 0
    for i, data in enumerate(variants):
        path = tmp_path / f"v{i}.webp"
        path.write_bytes(data)
        if not _pillow_opens(path):
            with pytest.raises(ValueError, match=f"v{i}.webp"):
                images.read_image_size(path)
        if _pillow_refuses(path):
            refused += 1
            with pytest.raises(ValueError, match=f"v{i}.webp"):
                images.read_rgb(path)
            continue
        _assert_reads_as_pillow(path)
    assert refused >= 6  # every cut, at least


class _VP8LBits:
    """A VP8L bit stream written by hand, least significant bit first:
    what libwebp's encoder never writes."""

    def __init__(self, w: int, h: int):
        self.bits = []
        self.put(0x2F, 8)
        self.put(w - 1, 14)
        self.put(h - 1, 14)
        self.put(0, 4)  # no alpha hint, version 0

    def put(self, v: int, n: int) -> "_VP8LBits":
        self.bits += [(v >> i) & 1 for i in range(n)]
        return self

    def code(self, c: int, n: int) -> "_VP8LBits":
        """A prefix code of n bits, its most significant bit first."""
        self.bits += [(c >> (n - 1 - i)) & 1 for i in range(n)]
        return self

    def simple(self, *symbols) -> "_VP8LBits":
        """A simple prefix code of 1 or 2 symbols under 256."""
        wide = len(symbols) == 2 or symbols[0] > 1
        self.put(1, 1).put(len(symbols) - 1, 1).put(int(wide), 1)
        for sym in symbols:
            self.put(sym, 8 if wide else 1)
        return self

    def normal(self, lengths: dict, alphabet: int) -> "_VP8LBits":
        """A normal prefix code of code lengths 0-2 (``lengths``: symbol
        -> length), each sent by a code-length code of lengths 2, 2, 1
        for 0, 1, 2."""
        self.put(0, 1).put(5 - 4, 4)
        for n in (0, 0, 2, 2, 1):  # code-length order 17, 18, 0, 1, 2
            self.put(n, 3)
        self.put(0, 1)  # lengths for the whole alphabet
        codes = {2: (0, 1), 0: (2, 2), 1: (3, 2)}
        for sym in range(alphabet):
            self.code(*codes[lengths.get(sym, 0)])
        return self

    def webp(self) -> bytes:
        b = self.bits + [0] * (-len(self.bits) % 8)
        vp8l = bytes(sum(b[i + k] << k for k in range(8))
                     for i in range(0, len(b), 8))
        chunk = b"VP8L" + _le32(len(vp8l)) + vp8l + b"\0" * (len(vp8l) & 1)
        return b"RIFF" + _le32(4 + len(chunk)) + b"WEBP" + chunk


def _plain_codes(b: _VP8LBits, green, red=(0,), blue=(0,), alpha=(0,)):
    """No color cache and no entropy image, then one group's codes."""
    b.put(0, 1).put(0, 1)
    b.simple(*green).simple(*red).simple(*blue).simple(*alpha).simple(0)
    return b


def _hand_streams() -> dict:
    """name -> a hand-written VP8L file Pillow decodes."""
    rng = np.random.default_rng(9)
    # 3 colors bundled 4 to a byte: index 3 reads past the palette
    pal = _VP8LBits(5, 3).put(1, 1).put(3, 2).put(2, 8).put(0, 1)
    pal.simple(10).simple(200).simple(30).simple(255).simple(0)
    pal.put(0, 1)  # no more transforms
    _plain_codes(pal, (0x1B, 0xFF))
    for i in range(2 * 3):
        pal.put(i % 2, 1)
    # predictor tiles of modes 14 and 15
    pred = _VP8LBits(9, 6).put(1, 1).put(0, 2).put(0, 3).put(0, 1)
    pred.simple(14, 15).simple(0).simple(0).simple(0).simple(0)
    for i in range(3 * 2):
        pred.put(i % 2, 1)
    pred.put(0, 1)
    _plain_codes(pred, (7, 130), (3, 90), (11, 250), (0, 255))
    for _ in range(9 * 6):
        pred.put(int(rng.integers(16)), 4)
    # a normal code with a run of zero lengths
    full = _VP8LBits(4, 2).put(0, 1).put(0, 1).put(0, 1).simple(0)
    full.normal({0: 1, 1: 2, 2: 2}, 256).simple(0).simple(0).simple(0)
    for i in range(8):
        full.code(*((0, 1), (2, 2), (3, 2))[i % 3])
    return {"palette index past the end": pal.webp(),
            "predictor modes 14 and 15": pred.webp(),
            "normal prefix code": full.webp()}


def _hand_refusals() -> dict:
    """name -> (a hand-written VP8L file Pillow refuses, the reason)."""
    def bare():
        return _VP8LBits(4, 2)
    repeat = bare().put(1, 1).put(2, 2).put(1, 1).put(2, 2).put(0, 1)
    _plain_codes(repeat, (0,))
    out = {"a repeated transform": (repeat, "a transform repeats")}
    for bits in (0, 12):
        b = bare().put(0, 1).put(1, 1).put(bits, 4).put(0, 1)
        for _ in range(5):
            b.simple(0)
        out[f"color cache of {bits} bits"] = (b, "bad color cache size")
    for name, lengths in (("an incomplete code", {0: 1, 1: 2}),
                          ("an over-subscribed code", {0: 1, 1: 1, 2: 1})):
        b = bare().put(0, 1).put(0, 1).put(0, 1).simple(0)
        b.normal(lengths, 256).simple(0).simple(0).simple(0)
        out[name] = (b, "invalid prefix code")
    # the first pixel a copy: symbol 256, distance code 1 (a row up)
    ref = bare().put(0, 1).put(0, 1).put(0, 1).normal({0: 1, 256: 1}, 280)
    ref.simple(0).simple(0).simple(0).simple(0).code(1, 1)
    out["a back reference before the first pixel"] = (ref,
                                                       "bad back reference")
    # code-length code over 17, 0, 1; 250 zeros, then a run of 10 more
    run = bare().put(0, 1).put(0, 1).put(0, 1).simple(0).put(0, 1)
    run.put(4 - 4, 4)
    for n in (1, 0, 2, 2):  # 17, 18, 0, 1
        run.put(n, 3)
    run.put(0, 1)
    for _ in range(250):
        run.code(2, 2)
    run.code(0, 1).put(7, 3).simple(0).simple(0).simple(0)
    out["a code-length run past the alphabet"] = (run, "past the alphabet")
    return {k: (b.webp(), why) for k, (b, why) in out.items()}


@pytest.mark.parametrize("what", sorted(_hand_streams()))
def test_hand_written_vp8l_as_pillow(tmp_path, what):
    path = tmp_path / "hand.webp"
    path.write_bytes(_hand_streams()[what])
    _assert_reads_as_pillow(path)
    if what == "palette index past the end":  # libwebp's zero padding
        assert not images.read_rgb(path)[0, 0].any()


@pytest.mark.parametrize("what", sorted(_hand_refusals()))
def test_hand_written_vp8l_refused(tmp_path, what):
    blob, reason = _hand_refusals()[what]
    path = tmp_path / "hand.webp"
    path.write_bytes(blob)
    assert _pillow_refuses(path), what
    with pytest.raises(ValueError, match=f"hand.webp: .*{reason}"):
        images.read_rgb(path)


def test_size_from_the_headers_of_a_file_whose_frame_is_corrupt(tmp_path):
    blob = bytearray((FIXTURES / "w_lossless_96x80_q50_m3.webp").read_bytes())
    blob[40:60] = bytes(20)
    path = tmp_path / "c.webp"
    path.write_bytes(bytes(blob))
    assert _pillow_refuses(path)
    with Image.open(path) as im:
        assert images.read_image_size(path) == im.size == (96, 80)


def test_bytes_past_the_riff_chunk_and_unknown_chunks_ignored(tmp_path):
    raw = (FIXTURES / "w_alph_raw_gradient.webp").read_bytes()
    extra = b"ZZZZ" + _le32(3) + b"abc\x00"
    body = raw[12:] + extra
    for name, data in [("trailing.webp", raw + b"junk after the RIFF"),
                       ("unknown.webp", b"RIFF" + _le32(4 + len(body)) +
                        b"WEBP" + body)]:
        path = tmp_path / name
        path.write_bytes(data)
        _assert_reads_as_pillow(path)


# ------------------------------------------- the precompute and generate
def _jax_native_ready() -> bool:
    """The JAX package's native library loaded (not its PIL fallback);
    retried while another test process may still be writing it."""
    for _ in range(60):
        if jax_native.available():
            return True
        jax_native._tried = False
        time.sleep(0.5)
    return False


def _webp_folder(tmp_path) -> Path:
    """Lossy, lossy with alpha, lossless and animated WebPs, a JPEG and a
    palette PNG at four sizes, with captions."""
    d = tmp_path / "imgs"
    d.mkdir()
    sizes = [(64, 64), (80, 64), (70, 60), (64, 80)]
    kinds = [(3, dict(quality=80)), (4, dict(quality=60, method=6)),
             (3, dict(lossless=True)), (4, dict(lossless=True, exact=True))]
    for i, (c, kw) in enumerate(kinds):
        w, h = sizes[i]
        _save(d / f"w{i}.webp", _pixels(w, h, c, 40 + i), **kw)
    w, h = sizes[1]
    f1 = np.zeros((h, w, 4), np.uint8)
    f1[8:40, 10:60] = _pixels(50, 32, 4, 50)
    f1[8:40, 10:60, 3] = 255
    Image.fromarray(f1).save(d / "anim.webp", "WEBP", save_all=True,
                             append_images=[Image.fromarray(
                                 _pixels(w, h, 4, 51))], quality=85)
    Image.fromarray(_pixels(*sizes[2], 3, 52)).save(d / "j.jpg", "JPEG",
                                                    quality=85)
    rng = np.random.default_rng(53)
    Image.fromarray(rng.integers(0, 256, (80, 64, 3)).astype(np.uint8)
                    ).quantize(16).save(d / "p.png")
    for i, p in enumerate(sorted(d.iterdir())):
        p.with_suffix(".txt").write_text(f"caption {i}, tag")
    return d


def test_precompute_on_webp_files_writes_the_same_cache_as_jax(tmp_path):
    assert _jax_native_ready()
    d = _webp_folder(tmp_path)
    raw = {"data": {"train_data_dir": [str(d)]}, "global_config": {
        "image": {"min_size": [32, 32], "max_size": [96, 96],
                  "bucket_step": 16}}}
    jc, tc = JConfig.from_dict(raw), TConfig.from_dict(raw)

    def enc_i(px):
        return np.asarray(px)[:, :, ::4, ::4] * 0.5

    def enc_p(captions):
        n = len(captions)
        return {"prompt_embeds": np.full((n, 77, 8), len(captions[0]),
                                         np.float32),
                "pooled_prompt_embeds": np.arange(n * 4, dtype=np.float32
                                                  ).reshape(n, 4)}

    jd = JD.create_dataset(jc, cache_manager=JCa.CacheManager(tmp_path / "j"))
    td = TD.create_dataset(tc, cache_manager=TCa.CacheManager(tmp_path / "t"))
    assert len(td.image_paths) == 7
    assert jd.bucket_indices == td.bucket_indices
    for ds in (jd, td):
        assert ds.precompute(enc_i, enc_p, batch_size=2, center_crop=False,
                             random_flip=True) == 7
    assert jd.cache.index == td.cache.index
    for key in jd.cache.index:
        a, b = jd.cache.load_latents(key), td.cache.load_latents(key)
        assert a.keys() == b.keys()
        for k in a:
            if k == "metadata":
                assert a[k] == b[k]
            else:
                assert np.array_equal(a[k], b[k]), (key, k)


@pytest.mark.parametrize("src,dst", [((60, 80), (64, 64)),
                                     ((48, 48), (48, 48))])
def test_generate_init_and_mask_from_webp_match_jax(tmp_path, src, dst):
    h, w = src
    init = tmp_path / "init.webp"
    _save(init, _pixels(w, h, 4, 5), quality=85)
    mask = tmp_path / "mask.webp"
    rng = np.random.default_rng(6)
    _save(mask, rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
          lossless=True)
    th, tw = dst
    np.testing.assert_array_equal(
        generate._load_images([init], th, tw)[0],
        jax_generate._load_images([str(init)], th, tw)[0])
    np.testing.assert_array_equal(
        generate._load_masks([mask], th, tw)[0],
        jax_generate._load_masks([str(mask)], th, tw)[0])


def test_decode_from_threads_at_once_on_a_cold_build(tmp_path, monkeypatch):
    """More threads than cores decode at once, with a short switch
    interval, while the WebP library builds for the first time: one
    build, and each thread gets the serial result."""
    path = tmp_path / "t.webp"
    _save(path, _pixels(96, 64, 4, 7), quality=90)
    want = np.asarray(Image.open(path).convert("RGB"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.load_webp.cache_clear()
    n = 2 * (os.cpu_count() or 4)
    out, errors = [None] * n, []

    def run(i):
        try:
            out[i] = images.read_rgb(path)
        except Exception as e:  # reported below
            errors.append(e)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
        native.load_webp.cache_clear()
    assert not errors, errors
    assert len(list((tmp_path / "build").iterdir())) == 1
    for got in out:
        assert np.array_equal(got, want)


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: a WebP library that does not build raises."""
    bad = tmp_path / "webp_decode.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_WEBP_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.load_webp.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            images.read_rgb(FIXTURES / "w_lossy_1x1_q75_m4.webp")
    finally:
        native.load_webp.cache_clear()
