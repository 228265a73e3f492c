"""PyTorch port: JPEG as libjpeg-turbo reads it, against Pillow and JAX.

The port's ``read_rgb`` / ``read_gray`` / ``read_image_size`` equal
Pillow's ``convert("RGB")`` / ``convert("L")`` / ``.size``
(``np.array_equal``), and refuse exactly what Pillow refuses, on:

* arithmetic-coded files (SOF9 sequential, SOF10 progressive, with and
  without restart markers, DAC conditioning or none), made by
  libjpeg-turbo's own encoder re-coding a Pillow file
  (``tools.make_image_fixtures.transcode``): each also decodes as its
  Huffman source;
* lossless files (SOF3: predictors 1-7, point transforms 0 and 2,
  restart intervals, 1 and 3 components, 4:2:0, one scan a component)
  from the fixture tool's encoder: each equals its source at Pt 0;
* progressive files cut short after some scans, which libjpeg smooths;
* a seeded sweep of byte flips past the first scan header and cuts of
  baseline, restart and progressive files (400 files), some decoded with
  libjpeg's recovery and some refused; it holds files whose pixels
  depend on libjpeg-turbo's SIMD IDCT overflowing where its C IDCT
  would not;
* refusals: 12-bit samples, hierarchical frames, a DNL height,
  arithmetic lossless (SOF11), lossless YCbCr, truncated files without
  EOI and arithmetic data past Pillow's first 64 KiB read.

The precompute over a folder of arithmetic, lossless, smoothed and
damaged JPEGs writes a cache and buckets bit-equal to the JAX
package's, and ``generate.py``'s ``--init`` from an arithmetic JPEG
equals JAX's ``_load_images``.  The committed fixtures
(``tests/fixtures/images/``) equal their manifest and live Pillow.
"""
import io
import json
import os
import struct
import subprocess
import sys
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
from sdxl_training_improvements_tpu_torch import generate, images
from sdxl_training_improvements_tpu_torch.config import Config as TConfig
from sdxl_training_improvements_tpu_torch.data import cache as TCa
from sdxl_training_improvements_tpu_torch.data import dataset as TD
from tools.make_image_fixtures import (
    _sampled, cut_after_scans, encode_lossless, scan_starts, transcode,
    without_segments)

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"
SIZES = [(1, 1), (17, 9), (33, 65), (256, 160)]
NEW_FIXTURES = ("a_", "l_", "t_", "d_", "entry_arith", "entry_lossless")


def _pixels(w: int, h: int, channels: int, seed: int) -> np.ndarray:
    """Seeded gradients with noise (small enough as JPEGs that an
    arithmetic file stays inside Pillow's first 64 KiB read)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * (k + 1) + y * (3 - k)) * 200 // (4 * (w + h))
                     + 20 * k for k in range(channels)], -1)
    a = np.clip(base + rng.integers(-12, 13, base.shape), 0, 255)
    return a.astype(np.uint8)


def _jpeg(a: np.ndarray, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(a[..., 0] if a.shape[2] == 1 else a).save(b, "JPEG", **kw)
    return b.getvalue()


def _pillow(path):
    """Pillow's (size, RGB, L), or None where it refuses the file."""
    try:
        with Image.open(path) as im:
            return im.size, np.asarray(im.convert("RGB")), np.asarray(
                im.convert("L"))
    except (OSError, SyntaxError, ValueError):
        return None


def _port(path):
    try:
        return (images.read_image_size(path), images.read_rgb(path),
                images.read_gray(path))
    except ValueError as e:
        assert str(path) in str(e)  # the refusal names the file
        return None


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return a[0] == b[0] and all(np.array_equal(x, y) for x, y in
                                zip(a[1:], b[1:]))


def _assert_reads_as_pillow(path) -> tuple:
    want = _pillow(path)
    assert want is not None, f"Pillow refuses {path}"
    assert _same(_port(path), want), path
    return want


# ------------------------------------------------------------ fixtures
def _manifest() -> dict:
    return json.loads((FIXTURES / "manifest.json").read_text())


@pytest.mark.parametrize("name", sorted(
    n for n in _manifest()["files"]
    if n.startswith(NEW_FIXTURES) and n.endswith(".jpg")))
def test_libjpeg_fixture_reads_as_pillow(name):
    """Each fixture equals live Pillow (size, RGB, L); an arithmetic
    file's decode is its Huffman source's, a lossless one's its source
    samples (the manifest's ``source_rgb_sha256``)."""
    import hashlib
    entry = _manifest()["files"][name]
    size, rgb, _ = _assert_reads_as_pillow(FIXTURES / name)
    assert list(size) == entry["size"]
    digest = hashlib.sha256(rgb.tobytes()).hexdigest()
    assert digest == entry["rgb_sha256"]
    if "source_rgb_sha256" in entry:
        assert digest == entry["source_rgb_sha256"]


# ------------------------------------------------------------ arithmetic
_ARITH = [(size, kind) for size in SIZES
          for kind in ("seq", "seq_rst", "prog", "prog_rst")]


@pytest.mark.parametrize("size,kind", _ARITH)
def test_arithmetic_reads_as_its_huffman_source(tmp_path, size, kind):
    w, h = size
    for mode, sub in (("RGB", 2), ("L", 0), ("RGB", 0)):
        a = _pixels(w, h, 3 if mode == "RGB" else 1, w * 7 + h + sub)
        src = _jpeg(a, quality=90, subsampling=sub)
        blob = transcode(src, progressive=kind.startswith("prog"),
                         restart_rows=1 if kind.endswith("rst") else 0)
        assert (b"\xff\xc9" if kind.startswith("seq") else b"\xff\xca"
                ) in blob
        (tmp_path / "src.jpg").write_bytes(src)
        path = tmp_path / f"{mode}{sub}.jpg"
        path.write_bytes(blob)
        got = _assert_reads_as_pillow(path)
        assert _same(got, _pillow(tmp_path / "src.jpg"))


def test_arithmetic_conditioning_and_missing_dac(tmp_path):
    """DAC conditioning other than libjpeg's defaults, and a file whose
    DAC segments are left out (the defaults L 0, U 1, K 5 then hold)."""
    src = _jpeg(_pixels(40, 24, 3, 9), quality=85, subsampling=2)
    (tmp_path / "src.jpg").write_bytes(src)
    want = _pillow(tmp_path / "src.jpg")
    for i, blob in enumerate((
            transcode(src, dac=(3, 7, 20)),
            transcode(src, progressive=True, dac=(1, 4, 2)),
            without_segments(transcode(src, progressive=True), 0xCC))):
        path = tmp_path / f"{i}.jpg"
        path.write_bytes(blob)
        assert _same(_assert_reads_as_pillow(path), want)
    assert b"\xff\xcc" not in blob[:scan_starts(blob)[0]]


# -------------------------------------------------------------- lossless
_LOSSLESS = [(size, p) for size in SIZES for p in (1, 4, 7)] + [
    ((23, 17), p) for p in (2, 3, 5, 6)]


@pytest.mark.parametrize("size,predictor", _LOSSLESS)
def test_lossless_reads_as_its_source(tmp_path, size, predictor):
    w, h = size
    rng = np.random.default_rng(w * 31 + h + predictor)
    a = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    cases = {  # name: (sampling factors, encoder options)
        "rgb": ([(1, 1)] * 3, {}),
        "rgb_pt2_rst": ([(1, 1)] * 3, dict(pt=2, restart_rows=1)),
        "gray_rst": ([(1, 1)], dict(restart_rows=2)),
        "scans": ([(1, 1)] * 3, dict(interleaved=False, restart_rows=1)),
        "420": ([(2, 2), (1, 1), (1, 1)], dict(restart_rows=1)),
    }
    for name, (factors, kw) in cases.items():
        planes = _sampled(a[..., :len(factors)], factors)
        path = tmp_path / f"{name}.jpg"
        path.write_bytes(encode_lossless(planes, factors, predictor=predictor,
                                         width=w, height=h, **kw))
        _, rgb, _ = _assert_reads_as_pillow(path)
        if len(factors) == 3 and factors[0] == (1, 1):
            pt = kw.get("pt", 0)
            assert np.array_equal(rgb, a >> pt << pt), name
        elif len(factors) == 1:
            assert np.array_equal(rgb, np.repeat(a[..., :1], 3, 2)), name


# ------------------------------------------------------------- smoothing
@pytest.mark.parametrize("size", SIZES + [(16, 40), (40, 17)])
def test_progressive_cut_short_is_smoothed_as_pillow(tmp_path, size):
    """A progressive file (Huffman or arithmetic) cut after each of its
    scans, EOI put back: libjpeg smooths the blocks whose coefficients
    1-9 stay unrefined (estimating the DC too where only DC scans came)."""
    w, h = size
    for mode, sub in (("RGB", 2), ("L", 0)):
        src = _jpeg(_pixels(w, h, 3 if mode == "RGB" else 1, w + h),
                    quality=75, subsampling=sub, progressive=True)
        for arith in (False, True):
            blob = transcode(src, progressive=True) if arith else src
            for k in range(1, len(scan_starts(blob))):
                path = tmp_path / f"{mode}{int(arith)}_{k}.jpg"
                path.write_bytes(cut_after_scans(blob, k))
                _assert_reads_as_pillow(path)


# ----------------------------------------------------------- damage sweep
def _damaged(blob: bytes, seed: int) -> bytes:
    """The ``seed``th damage of ``blob``: one to three seeded byte flips
    past the first scan header, or (one seed in four) a cut anywhere
    past it."""
    rng = np.random.default_rng(seed)
    sos = blob.index(b"\xff\xda")
    start = sos + 2 + (blob[sos + 2] << 8 | blob[sos + 3])
    if seed % 4 == 3:
        return blob[:int(rng.integers(start, len(blob)))]
    b = bytearray(blob)
    for _ in range(int(rng.integers(1, 4))):
        b[int(rng.integers(start, len(b) - 2))] ^= int(rng.integers(1, 256))
    return bytes(b)


_SWEEP = {"baseline": {}, "restart": dict(restart_marker_blocks=4),
          "progressive": dict(progressive=True),
          "progressive_restart": dict(progressive=True,
                                      restart_marker_rows=1)}


def _sweep_source(kind: str) -> bytes:
    """An 80x64 RGB file at quality 90 from Pillow."""
    rng = np.random.default_rng(1000)
    y, x = np.mgrid[0:64, 0:80]
    a = np.stack([(x * 3 + y * 2 + rng.integers(0, 40, (64, 80))) % 256,
                  (x * 5 + rng.integers(0, 60, (64, 80))) % 256,
                  (y * 4 + rng.integers(0, 30, (64, 80))) % 256], -1)
    return _jpeg(a.astype(np.uint8), quality=90, **_SWEEP[kind])


@pytest.mark.parametrize("kind", sorted(_SWEEP))
def test_damage_sweep_reads_and_refuses_as_pillow(tmp_path, kind):
    """100 seeded damages of each kind: refused where Pillow refuses
    them, else ``np.array_equal`` to Pillow; both outcomes occur."""
    src = _sweep_source(kind)
    outcomes = {"read": 0, "refused": 0}
    for seed in range(100):
        path = tmp_path / f"{seed}.jpg"
        path.write_bytes(_damaged(src, seed))
        want = _pillow(path)
        assert _same(_port(path), want), (kind, seed)
        outcomes["read" if want is not None else "refused"] += 1
    assert min(outcomes.values()) >= 10, outcomes


def _header_damaged(blob: bytes, seed: int) -> bytes:
    """``blob`` with 1-2 seeded byte flips in its headers: between the SOI
    and the end of the first scan header."""
    rng = np.random.default_rng(50000 + seed)
    sos = blob.index(b"\xff\xda")
    start = sos + 2 + (blob[sos + 2] << 8 | blob[sos + 3])
    b = bytearray(blob)
    for _ in range(int(rng.integers(1, 3))):
        b[int(rng.integers(2, start))] ^= int(rng.integers(1, 256))
    return bytes(b)


@pytest.mark.parametrize("kind", sorted(_SWEEP))
def test_header_damage_reads_and_refuses_as_pillow(tmp_path, kind):
    """50 seeded flips of each kind in the frame, table and scan headers:
    refused where Pillow refuses them, else ``np.array_equal`` to
    Pillow; both outcomes occur.  The size reader alone refuses
    (``images.ImageRefused``, naming the file) exactly where
    ``Image.open`` refuses, and reads its size elsewhere."""
    src = _sweep_source(kind)
    outcomes = {"read": 0, "refused": 0, "opened": 0, "unopened": 0}
    for seed in range(50):
        path = tmp_path / f"{seed}.jpg"
        path.write_bytes(_header_damaged(src, seed))
        want = _pillow(path)
        assert _same(_port(path), want), (kind, seed)
        outcomes["read" if want is not None else "refused"] += 1
        try:
            with Image.open(path) as im:
                opened = im.size
        except (OSError, SyntaxError, ValueError,
                Image.DecompressionBombError):
            opened = None
        try:
            size = images.read_image_size(path)
        except images.ImageRefused as e:
            assert str(path) in str(e)
            size = None
        assert size == opened, (kind, seed)
        outcomes["opened" if opened is not None else "unopened"] += 1
    assert min(outcomes["read"], outcomes["refused"]) >= 5, outcomes
    assert outcomes["unopened"] >= 1, outcomes


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + (
        payload)


def _8bim(code: int, name: bytes, data: bytes) -> bytes:
    """A Photoshop image resource block (its name a Pascal string and its
    data padded to even lengths)."""
    name = bytes([len(name)]) + name
    name += b"\0" * (len(name) & 1)
    return (b"8BIM" + code.to_bytes(2, "big") + name
            + len(data).to_bytes(4, "big") + data + b"\0" * (len(data) & 1))


def _mpf(entries, head: bytes = b"II*\0", cut: int = 0,
         declared: int = 0) -> bytes:
    """An MPF APP2 segment: a TIFF header ``head`` and one directory of
    ``entries`` (tag, type, count, value: inline if four bytes or fewer,
    else after the directory), which says it holds ``declared`` entries
    if that is given, less the segment's last ``cut`` bytes."""
    e = ">" if head[:2] == b"MM" else "<"
    at = 8 + 2 + 12 * len(entries) + 4
    body = struct.pack(e + "H", declared or len(entries))
    tail = b""
    for tag, typ, count, value in entries:
        body += struct.pack(e + "HHL", tag, typ, count)
        if len(value) <= 4:
            body += value.ljust(4, b"\0")
        else:
            body += struct.pack(e + "L", at + len(tail))
            tail += value
    blob = head + struct.pack(e + "L", 8) + body + b"\0\0\0\0" + tail
    return _segment(0xE2, b"MPF\0" + blob[:len(blob) - cut])


def _mp_entries(*formats: int, e: str = "<") -> bytes:
    """MP entries (16 bytes each) of the given image data formats."""
    return b"".join(struct.pack(e + "LLLHH", f << 24, 100, 0, 0, 0)
                    for f in formats)


_U32 = struct.pack("<L", 2)  # an image count of 2 (little-endian LONG)
_PS = b"Photoshop 3.0\0"
_NO_NAME = b"8BIM\x04\x04"  # a resource block cut after its code
_SOF_16x8 = bytes([8, 0, 8, 0, 16, 3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
# name: (segments right after the SOI, segments right before the first
# scan, after the frame header)
_HEADER_SEGMENTS = {
    "jfif_6": (_segment(0xE0, b"JFIF\0\x01"), b""),
    "jfif_7": (_segment(0xE0, b"JFIF\0\x01\x02"), b""),
    "adobe_6": (_segment(0xEE, b"Adobe\0"), b""),
    "adobe_7": (_segment(0xEE, b"Adobe\0\x64"), b""),
    "ps_cut_in_code": (_segment(0xED, _PS + b"8BIM\x04"), b""),
    "ps_no_name_length": (_segment(0xED, _PS + _NO_NAME), b""),
    "ps_cut_in_name": (_segment(0xED, _PS + _NO_NAME + b"\x05ab"), b""),
    "ps_cut_in_size": (_segment(0xED, _PS + _NO_NAME + b"\0\0\0\0"),
                       b""),
    "ps_whole_then_bad": (_segment(0xED, _PS + _8bim(0x0404, b"ab", b"xyz")
                                   + _NO_NAME), b""),
    "ps_resolution_13_then_bad": (_segment(0xED, _PS + _8bim(
        0x03ED, b"", bytes(13)) + _NO_NAME), b""),
    "ps_resolution_14_then_bad": (_segment(0xED, _PS + _8bim(
        0x03ED, b"", bytes(14)) + _NO_NAME), b""),
    "ps_size_past_end": (_segment(0xED, _PS + _NO_NAME + b"\0\0\0\1\0"
                                  + b"8BIM"), b""),
    "icc_13": (_segment(0xE2, b"ICC_PROFILE\0\x01"), b""),
    "icc_14": (_segment(0xE2, b"ICC_PROFILE\0\x01\x01"), b""),
    "icc_13_after_frame": (b"", _segment(0xE2, b"ICC_PROFILE\0\x01")),
    # a second frame header (Pillow takes its size) checks only the ICC
    # chunks since the first: the short one that sorts after a whole one
    "icc_13_between_frames": (_segment(0xE2, b"ICC_PROFILE\0\x01\x01"),
                              _segment(0xE2, b"ICC_PROFILE\0\x02")
                              + _segment(0xC0, _SOF_16x8)),
    # MPF (Pillow's MPO check): only an entry table shorter than the image
    # count, reached before an entry that is not JPEG, is refused
    "mpf_not_tiff": (_segment(0xE2, b"MPF\0xx"), b""),
    "mpf_no_count": (_mpf([(0xB000, 7, 4, b"0100")]), b""),
    "mpf_short": (_mpf([(0xB001, 4, 1, _U32), (0xB002, 7, 16,
                                                 _mp_entries(0))]), b""),
    "mpf_whole": (_mpf([(0xB001, 4, 1, _U32), (0xB002, 7, 32,
                                                 _mp_entries(0, 0))]), b""),
    "mpf_not_jpeg_then_short": (_mpf([(0xB001, 4, 1, b"\3\0\0\0"), (
        0xB002, 7, 32, _mp_entries(0, 1))]), b""),
    "mpf_count_short_type": (_mpf([(0xB001, 3, 1, b"\2\0"), (
        0xB002, 1, 16, _mp_entries(0))]), b""),
    "mpf_count_signed_negative": (_mpf([(0xB001, 9, 1, b"\xff" * 4), (
        0xB002, 7, 16, _mp_entries(0))]), b""),
    "mpf_count_rational": (_mpf([(0xB001, 5, 1, bytes([2, 0, 0, 0, 1, 0, 0,
                                                       0])),
                                 (0xB002, 7, 16, _mp_entries(0))]), b""),
    "mpf_entries_long": (_mpf([(0xB001, 4, 1, _U32), (0xB002, 4, 4,
                                                        _mp_entries(0))]),
                         b""),
    "mpf_big_endian_short": (_mpf([(0xB001, 4, 1, b"\0\0\0\2"), (
        0xB002, 7, 16, _mp_entries(0, e=">"))], head=b"MM\0*"), b""),
    # a directory read big-endian whose entries Pillow reads little-endian
    "mpf_mm2a00_short": (_mpf([(0xB001, 4, 1, b"\0\0\0\2"), (
        0xB002, 7, 16, b"\1" + bytes(15))], head=b"MM*\0"), b""),
    # a directory that says it has 5 entries: the tags before the short
    # read count
    "mpf_directory_cut": (_mpf([(0xB001, 4, 1, _U32), (0xB002, 7, 16,
                                                         _mp_entries(0))],
                               declared=5), b""),
    "mpf_entries_past_end": (_mpf([(0xB001, 4, 1, _U32), (0xB002, 7, 16,
                                                            _mp_entries(0))],
                                  cut=1), b""),
    "dqt_short": (_segment(0xDB, b"\x03" + bytes(40)), b""),
    "dqt_16bit": (_segment(0xDB, b"\x13" + b"\0\x01" * 64), b""),
    "dqt_16bit_short": (_segment(0xDB, b"\x13" + bytes(65)), b""),
}


@pytest.mark.parametrize("name", sorted(_HEADER_SEGMENTS))
def test_header_segments_read_and_refused_as_pillow(tmp_path, name):
    """The segments whose checks ``read_image_size`` copies from Pillow's
    parser (``JpegImageFile._open``): short JFIF and Adobe markers, a
    Photoshop APP13 cut in each field of a resource block or ended by a
    short ResolutionInfo, short ICC chunks before, after and between
    frame headers, DQT segments shorter than their table, MPF segments
    (the MPO index ``Image.open`` reads), each put into a Pillow file.
    The size, or the refusal, is Pillow's ``.size``'s, and the pixels
    are Pillow's."""
    head, tail = _HEADER_SEGMENTS[name]
    src = _jpeg(_pixels(24, 16, 3, 8), quality=90)
    sos = src.index(b"\xff\xda")
    path = tmp_path / f"{name}.jpg"
    path.write_bytes(src[:2] + head + src[2:sos] + tail + src[sos:])
    try:
        with Image.open(path) as im:
            want = im.size
    except (OSError, SyntaxError, ValueError):
        want = None
    try:
        got = images.read_image_size(path)
    except ValueError as e:
        assert str(path) in str(e)
        got = None
    assert got == want
    assert _same(_port(path), _pillow(path))


def test_damage_sweep_holds_idct_overflow_cases(tmp_path):
    """The baseline sweep holds files that Pillow reads whose pixels
    libjpeg-turbo's C IDCT (``JSIMD_FORCENONE=1``) would give otherwise
    than the SIMD one Pillow runs (16-bit lanes on out-of-range
    coefficients), and the port reads those as Pillow does."""
    src = _sweep_source("baseline")
    paths = []
    for seed in range(100):
        path = tmp_path / f"{seed}.jpg"
        path.write_bytes(_damaged(src, seed))
        if _pillow(path) is not None:
            paths.append(path)
    script = ("import sys, numpy as np; from PIL import Image\n"
              "for p in sys.argv[1:]:\n"
              "    np.save(p + '.c.npy', np.asarray("
              "Image.open(p).convert('RGB')))\n")
    subprocess.run([sys.executable, "-c", script, *map(str, paths)],
                   check=True, env={**os.environ, "JSIMD_FORCENONE": "1"})
    differ = [p for p in paths if not np.array_equal(
        np.load(str(p) + ".c.npy"), images.read_rgb(p))]
    assert len(differ) >= 4, differ
    for p in differ:
        assert np.array_equal(images.read_rgb(p), _pillow(p)[1])


# -------------------------------------------------------------- refusals
def test_refusals_match_pillow(tmp_path):
    """12-bit samples, hierarchical frames, a DNL height, arithmetic
    lossless (SOF11), lossless YCbCr (a JFIF marker), truncated files
    without EOI, arithmetic data past Pillow's first 64 KiB read, a frame
    component naming a quantization table past the four (Tq 4, 15, 255):
    Pillow refuses each, and so does the port, naming the file.  Pillow's
    ``.size`` of a hierarchical file is its frame's, and so is the
    port's."""
    base = _jpeg(_pixels(16, 8, 3, 4), quality=90)
    sof = base.index(b"\xff\xc0")
    a = np.random.default_rng(5).integers(0, 256, (9, 17, 3)).astype(
        np.uint8)
    lossless = encode_lossless([a[..., k] for k in range(3)], [(1, 1)] * 3,
                               width=17, height=9)
    l_sof = lossless.index(b"\xff\xc3")
    prog = _jpeg(_pixels(40, 24, 3, 6), quality=90, progressive=True)
    big = transcode(_jpeg(np.random.default_rng(7).integers(
        0, 256, (256, 320, 3)).astype(np.uint8), quality=95))
    assert len(big) > 65536
    cases = {
        "12-bit": base[:sof + 4] + b"\x0c" + base[sof + 5:],
        "DNL": base[:sof + 5] + b"\x00\x00" + base[sof + 7:],
        "sof11": lossless[:l_sof + 1] + b"\xcb" + lossless[l_sof + 2:],
        "lossless_ycc": encode_lossless([a[..., k] for k in range(3)],
                                        [(1, 1)] * 3, jfif=True, width=17,
                                        height=9),
        "arith_past_64k": big,
        **{f"tq_{tq}": base[:sof + 12] + bytes([tq]) + base[sof + 13:]
           for tq in (4, 15, 255)},
        **{f"sof{m:x}": base[:sof + 1] + bytes([m]) + base[sof + 2:]
           for m in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF)},
        **{f"cut_{i}": blob for i, blob in enumerate((
            base[:-2], base[:-1], prog[:-2], prog[:scan_starts(prog)[3]],
            lossless[:-2], transcode(base)[:-2]))},
    }
    for name, blob in cases.items():
        path = tmp_path / f"{name}.jpg"
        path.write_bytes(blob)
        assert _pillow(path) is None, name
        with pytest.raises(ValueError, match=f"{name}.jpg"):
            images.read_rgb(path)
        if name.startswith("sof") and name != "sof11":
            with Image.open(path) as im:
                assert images.read_image_size(path) == im.size


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


def _libjpeg_folder(tmp_path) -> Path:
    """An arithmetic (progressive and sequential), a lossless, a smoothed
    and a damaged-but-decodable JPEG at four sizes, with captions."""
    d = tmp_path / "imgs"
    d.mkdir()
    src = [_jpeg(_pixels(w, h, 3, i), quality=85, subsampling=2,
                 progressive=True) for i, (w, h) in enumerate(
                     [(64, 64), (80, 64), (70, 60), (64, 80)])]
    (d / "arith_prog.jpg").write_bytes(transcode(src[0], progressive=True))
    (d / "arith_seq.jpg").write_bytes(transcode(src[1], restart_rows=1))
    a = _pixels(70, 60, 3, 11)
    (d / "lossless.jpg").write_bytes(encode_lossless(
        [a[..., k] for k in range(3)], [(1, 1)] * 3, predictor=5,
        restart_rows=2, width=70, height=60))
    (d / "smoothed.jpg").write_bytes(cut_after_scans(src[2], 4))
    rst = _jpeg(_pixels(64, 80, 3, 12), quality=85, restart_marker_blocks=2)
    k = rst.index(b"\xff\xd3")
    (d / "damaged.jpg").write_bytes(rst[:k + 1] + b"\xd6" + rst[k + 2:])
    for i, p in enumerate(sorted(d.iterdir())):
        assert _pillow(p) is not None, p
        p.with_suffix(".txt").write_text(f"caption {i}, tag")
    return d


def test_precompute_on_libjpeg_files_writes_the_same_cache_as_jax(tmp_path):
    assert _jax_native_ready()
    d = _libjpeg_folder(tmp_path)
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
    assert len(td.image_paths) == 5
    assert jd.bucket_indices == td.bucket_indices
    for ds in (jd, td):
        assert ds.precompute(enc_i, enc_p, batch_size=2, center_crop=False,
                             random_flip=True) == 5
    assert jd.cache.index == td.cache.index
    for key in jd.cache.index:
        a, b = jd.cache.load_latents(key), td.cache.load_latents(key)
        assert a.keys() == b.keys()
        for k in a:
            if k == "metadata":
                assert a[k] == b[k]
            else:
                assert np.array_equal(a[k], b[k]), (key, k)


def test_generate_init_arithmetic_jpeg_matches_jax(tmp_path):
    init = tmp_path / "init.jpg"
    init.write_bytes(transcode(_jpeg(_pixels(80, 60, 3, 13), quality=90,
                                     progressive=True), progressive=True))
    for th, tw in ((64, 64), (60, 80)):
        np.testing.assert_array_equal(
            generate._load_images([init], th, tw)[0],
            jax_generate._load_images([str(init)], th, tw)[0])
