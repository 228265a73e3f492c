"""Image files as the JAX package reads them with Pillow, without Pillow.

The card's machine has no Pillow, so the port reads images here, for the
dataset's bucketing and precompute and for ``generate.py --init/--mask``:

* ``read_rgb(path)`` is ``Image.open(path).convert("RGB")`` as an HxWx3
  uint8 array, ``read_gray(path)`` is ``convert("L")`` (HxW), and
  ``read_image_size(path)`` is ``.size`` (width, height) from the
  headers alone: the frame header (SOFn) of a JPEG, IHDR of a PNG, the
  chunk headers of a WebP (its VP8X canvas, else its VP8 key-frame or
  VP8L header).
* The format is told by the file's leading bytes, as Pillow tells it,
  not by its extension.
* JPEG: what Pillow's libjpeg-turbo reads, decoded in C++
  (``native/jpeg_decode.cpp``) to Pillow's bits: baseline,
  extended-sequential and progressive frames, Huffman or arithmetic
  coded, and lossless frames (SOF3), with 1, 3 or 4 components; a
  progressive file cut short is block-smoothed, and a damaged stream is
  recovered from as libjpeg recovers (a bad Huffman code, a segment that
  runs out, a wrong restart marker, stray bytes).  The size comes from
  the headers as Pillow's own parser reads them.  What Pillow refuses is
  refused, raising ``ValueError`` naming the file and the reason: samples
  other than 8 bits, hierarchical and arithmetic-lossless frames, a
  height set by a DNL marker, lossless YCbCr, truncated streams, an
  arithmetic-coded scan past Pillow's first 64 KiB read, and an MPO
  index with fewer entries than its image count.
* PNG: every color type and bit depth, Adam7 included (``png.py``).
* WebP: lossy (VP8, with or without an ALPH chunk) and lossless (VP8L)
  frames, still or the first frame of an animation, decoded in C++
  (``native/webp_decode.cpp``) to the bits Pillow's libwebp gives.  The
  RIFF container is read here as libwebp's demuxer reads it; what it
  refuses (a RIFF size past the end of the file, a chunk past the RIFF
  chunk, a frame off its canvas, an ALPH chunk before VP8L, ...) and
  any frame the decoder refuses raise ``ValueError`` naming the file.
  An animation's first frame is drawn on a canvas of (0, 0, 0, 0) at
  its offset, as ``WebPAnimDecoder`` draws it; alpha is dropped.
* GIF and any other format raise, naming the file and the format.
  EXIF orientation, ICC profiles and comments are ignored, as
  ``convert`` ignores them.
* An image past Pillow's decompression-bomb limit (``max(1, w) *
  max(1, h)`` above ``2 * Image.MAX_IMAGE_PIXELS``, 178,956,970 pixels) is
  refused from its header's size, before any pixel buffer is made, as
  ``Image.open`` refuses it; between 1x and 2x it is read (Pillow only
  warns there).

Every refusal is a ``ValueError`` naming the file, of one of two kinds:
``ImageRefused`` for a file that ``Image.open`` refuses too (the JAX
package skips it in its bucketing), ``UnsupportedImage`` for a file of a
format the port does not read, which Pillow may read (the JAX package
trains on it, so skipping it would train on fewer images).
"""
from __future__ import annotations

import io
import struct
import zlib
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

from sdxl_training_improvements_tpu_torch import native, png

# the markers Pillow's JPEG parser knows (``JpegImagePlugin.MARKER``):
# frame headers, segments it steps over, and markers without a length
_JPEG_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
             0xCD, 0xCE, 0xCF, 0xDE}
_JPEG_SKIP = {0xC4, 0xCC, 0xDA, 0xDC, 0xDD, 0xDF}
_JPEG_BARE = {0xC8, *range(0xD0, 0xDA), *range(0xF0, 0xFE)}

# Pillow's ``Image.MAX_IMAGE_PIXELS`` (1024 * 1024 * 1024 // 4 // 3):
# ``Image.open`` raises ``DecompressionBombError`` past twice it
MAX_IMAGE_PIXELS = 89_478_485
# the (bit depth, color type) pairs Pillow's PNG reader has a mode for
_PNG_MODES = {(1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (8, 2), (16, 2),
              (1, 3), (2, 3), (4, 3), (8, 3), (8, 4), (16, 4), (8, 6),
              (16, 6)}


class ImageRefused(ValueError):
    """A file Pillow's ``Image.open`` refuses too: a header it cannot
    identify, a WebP container libwebp refuses, an image past the
    decompression-bomb limit."""


class UnsupportedImage(ValueError):
    """A file the port does not read and Pillow may: another format by
    its bytes (a GIF, BMP or TIFF, whatever its name)."""


def _check_pixels(path, size: tuple) -> tuple:
    """``size`` (width, height), or ``ImageRefused`` where
    ``Image.open`` raises ``DecompressionBombError`` on it."""
    w, h = size
    if max(1, w) * max(1, h) > 2 * MAX_IMAGE_PIXELS:
        raise ImageRefused(
            f"{path}: a {w}x{h} image, {max(1, w) * max(1, h)} pixels, past "
            f"Pillow's decompression-bomb limit of {2 * MAX_IMAGE_PIXELS}")
    return size


def _format(path, head: bytes) -> str:
    """"jpeg", "png" or "webp" from a file's first 16 bytes (for WebP,
    the first chunk Pillow's ``_accept`` asks for); others raise."""
    if head.startswith(b"\xff\xd8\xff"):
        return "jpeg"
    if head.startswith(png._SIGNATURE):
        return "png"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        if head[12:16] in (b"VP8 ", b"VP8L", b"VP8X"):
            return "webp"
        raise ImageRefused(f"{path}: a RIFF WEBP file whose first chunk is "
                           f"{head[12:16]!r} (Pillow cannot identify it)")
    kind = ("a GIF image" if head[:6] in (b"GIF87a", b"GIF89a") else
            "not a JPEG, PNG or WebP file")
    raise UnsupportedImage(f"{path}: {kind} (the port reads JPEG, PNG and "
                           "WebP images only)")


def _jpeg_app(m: int, seg: bytes, icc: list, fail) -> None:
    """The checks Pillow's APP handler makes of an APPn segment (what it
    parses and the exceptions that make the file unidentified)."""
    if (m == 0xE0 and seg.startswith(b"JFIF")) or (
            m == 0xEE and seg.startswith(b"Adobe")):
        if len(seg) < 7:
            fail("corrupt data (a short JFIF or Adobe segment)")
    elif m == 0xE2 and seg.startswith(b"ICC_PROFILE\0"):
        icc.append(seg)
    elif m == 0xED and seg.startswith(b"Photoshop 3.0\x00"):
        off = 14  # its image resource blocks, read until one is short
        while seg[off:off + 4] == b"8BIM":
            off += 4
            if off + 2 > len(seg):
                return
            code = struct.unpack(">H", seg[off:off + 2])[0]
            off += 2
            if off >= len(seg):
                fail("corrupt data (a short Photoshop resource)")
            off += 1 + seg[off]
            off += off & 1
            if off + 4 > len(seg):
                return
            n = struct.unpack(">I", seg[off:off + 4])[0]
            off += 4
            if code == 0x03ED and len(seg[off:off + n]) < 14:
                return  # a short ResolutionInfo ends the parse
            off += n
            off += off & 1


# TIFF (for an MPF segment's directory, as Pillow's ``ImageFileDirectory_v2``
# reads it): the headers it takes for a classic TIFF, the size of a value
# of each type it loads, and the types whose first value it gives as an int
_TIFF_HEADS = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a",
               b"MM\x00\x2b")
_TIFF_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
               11: 4, 12: 8, 13: 4, 16: 8}
_TIFF_INTS = {3: "H", 4: "L", 6: "b", 8: "h", 9: "l", 13: "L", 16: "Q"}


def _mpf_entries_short(mp: bytes) -> bool:
    """Whether Pillow's MPO check of an MPF segment (``mp``, its payload
    past "MPF\\0"; ``JpegImagePlugin._getmp``) stops on an MP entry table
    shorter than the image count, before any entry of a format other than
    JPEG: a ``struct.error``, which leaves the file unidentified.  Every
    other fault of the segment makes Pillow read the file as a JPEG."""
    if len(mp) < 8 or mp[:4] not in _TIFF_HEADS:
        return False
    e = ">" if mp[:2] == b"MM" else "<"
    off = struct.unpack(e + "L", mp[4:8])[0]
    tags = {}  # the directory's tags up to its end or a short read
    if off + 2 <= len(mp):
        pos = off + 2
        for _ in range(struct.unpack_from(e + "H", mp, off)[0]):
            if pos + 12 > len(mp):
                break
            tag, typ, count = struct.unpack_from(e + "HHL", mp, pos)
            data = mp[pos + 8:pos + 12]
            pos += 12
            if typ not in _TIFF_SIZES:
                continue
            size = count * _TIFF_SIZES[typ]
            if size > 4:
                at = struct.unpack(e + "L", data)[0]
                if at + size > len(mp):
                    break
                data = mp[at:at + size]
            if size:
                tags[tag] = typ, data[:size]
    if 0xB001 not in tags or tags[0xB001][0] not in _TIFF_INTS:
        return False
    typ, data = tags[0xB001]
    n = struct.unpack_from(e + _TIFF_INTS[typ], data)[0]
    if n <= 0 or tags.get(0xB002, (0,))[0] not in (1, 7):
        return False
    entries = tags[0xB002][1]
    e = ">" if mp[:4] == b"MM\x00\x2a" else "<"  # _getmp's own byte order
    for k in range(n):
        if len(entries) < 16 * k + 16:
            return True
        if struct.unpack_from(e + "L", entries, 16 * k)[0] >> 24 & 7:
            return False
    return False


def _jpeg_size(path, f) -> tuple:
    """(width, height) as Pillow's JPEG parser (``JpegImageFile._open``)
    reads them from ``f`` (just past the SOI): the markers up to the first
    SOS, the size from the last frame header among them, and the MPO
    index that ``Image.open`` reads after them (``jpeg_factory``).  What that
    parser refuses raises; what it accepts is the decoder's to judge (a
    hierarchical frame, for one, has a size but no pixels)."""
    def fail(why: str):
        raise ImageRefused(f"{path}: {why} (Pillow cannot identify the file)")

    def read(n: int) -> bytes:
        b = f.read(n)
        if len(b) < n:
            fail("truncated file (no frame header)")
        return b

    def segment() -> bytes:
        n = struct.unpack(">H", read(2))[0] - 2
        return read(n) if n > 0 else b""

    size, icc, mpf = None, [], None
    s = read(1)
    while True:
        if s[0] != 0xFF:  # bytes that are not a marker are skipped
            s = read(1)
            continue
        m = read(1)[0]
        if m == 0xFF:
            s = b"\xff"
            continue
        if m == 0:
            s = read(1)
            continue
        if m in _JPEG_SOF:
            seg = segment()
            if len(seg) < 6 or (len(seg) - 6) % 3:
                fail("corrupt data (bad frame header)")
            if seg[0] != 8:
                fail(f"{seg[0]}-bit samples (only 8-bit JPEGs are read)")
            if seg[5] not in (1, 3, 4):
                fail(f"cannot handle {seg[5]}-component images")
            if icc and len(sorted(icc)[0]) < 14:
                fail("corrupt data (a short ICC profile chunk)")
            icc = []
            size = struct.unpack(">H", seg[3:5])[0], struct.unpack(
                ">H", seg[1:3])[0]
        elif m == 0xDB:
            seg = segment()
            while seg:
                n = 1 + (64 if seg[0] < 16 else 128)
                if len(seg) < n:
                    fail("corrupt data (bad quantization table marker)")
                seg = seg[n:]
        elif 0xE0 <= m <= 0xEF:
            seg = segment()
            if m == 0xE2 and seg.startswith(b"MPF\0"):
                mpf = seg[4:]
            _jpeg_app(m, seg, icc, fail)
        elif m == 0xFE or m in _JPEG_SKIP:
            segment()
        elif m not in _JPEG_BARE:
            fail(f"no marker found (0xFF{m:02X})")
        if m == 0xDA:
            break
        s = read(1)
    if size is None or not size[0] or not size[1]:
        fail("no frame header" if size is None else
             "an empty image (its height set by a DNL marker)")
    if mpf is not None and _mpf_entries_short(mpf):
        fail("a malformed MPO index (fewer MP entries than its image "
             "count)")
    return size


# WebP (libwebp's demux.c): the largest chunk payload, the VP8X flags
# (animation, alpha, and all the defined ones) and the largest canvas
_WEBP_MAX_PAYLOAD = 0xFFFFFFFF - 8 - 1
_WEBP_ANIMATION, _WEBP_ALPHA, _WEBP_FLAGS = 0x02, 0x10, 0x3E
_WEBP_MAX_AREA = 1 << 32


class WebPLayout(NamedTuple):
    """Where a WebP file's first frame is, as ``WebPAnimDecoder`` finds
    it: the canvas (width, height), the frame's (x, y) on it and its
    (width, height), whether it is lossless, and the (offset, length) of
    its image chunk's payload (the padding byte included, as libwebp
    hands it to the decoder) and of its ALPH chunk's payload, or None."""
    canvas: tuple
    offset: tuple
    size: tuple
    lossless: bool
    image: tuple
    alpha: Optional[tuple]


def _le24(b: bytes) -> int:
    return b[0] | (b[1] << 8) | (b[2] << 16)


def webp_layout(path, read, file_size: int) -> WebPLayout:
    """The layout of the WebP file ``path`` whose bytes ``read(offset, n)``
    gives, checked as libwebp's demuxer checks it (``WebPDemux``, with
    ``WebPGetFeatures`` on each image chunk); what it refuses raises
    ``ValueError`` naming the file."""
    def fail(why: str):
        raise ImageRefused(f"{path}: {why} (WebP)")

    head = read(0, 20)
    if len(head) < 20:
        fail("truncated file")
    (riff,) = struct.unpack("<I", head[4:8])
    if riff < 8 or riff > _WEBP_MAX_PAYLOAD:
        fail(f"bad RIFF size {riff}")
    end = riff + 8  # bytes past the RIFF chunk are ignored
    if file_size < end:
        fail(f"truncated file (the RIFF header says {end} bytes, the file "
             f"has {file_size})")

    def chunk(pos: int) -> tuple:
        h = read(pos, 8)
        (size,) = struct.unpack("<I", h[4:8])
        if size > _WEBP_MAX_PAYLOAD:
            fail(f"bad {h[:4]!r} chunk size {size}")
        padded = size + (size & 1)
        if padded > end - pos - 8:
            fail(f"the {h[:4]!r} chunk runs past the RIFF chunk")
        return h[:4], size, padded

    def features(pos: int, tag: bytes, size: int, padded: int) -> tuple:
        """``WebPGetFeatures`` of the image chunk at ``pos``: its size."""
        data = read(pos + 8, min(padded, 30))
        if tag == b"VP8 ":
            if padded < 10:
                fail("truncated VP8 frame header")
            bits = _le24(data)
            if data[3:6] != b"\x9d\x01\x2a":
                fail("corrupt VP8 frame header (start code)")
            if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 \
                    or (bits >> 5) >= size:
                fail("corrupt VP8 frame header")
            w, h = (struct.unpack("<H", data[6:8])[0] & 0x3FFF,
                    struct.unpack("<H", data[8:10])[0] & 0x3FFF)
            if not w or not h:
                fail("a VP8 frame of size 0")
            return w, h
        if padded < 5 or data[0] != 0x2F or data[4] >> 5:
            fail("corrupt VP8L header")
        bits = int.from_bytes(data[1:5], "little")
        return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1

    def store_frame(pos: int, min_size: int) -> tuple:
        """``StoreFrame``: a frame's ALPH and image chunks from ``pos``;
        (the position after them, the frame as a dict)."""
        if end - pos < 8 or end - pos < min_size:
            fail("truncated file")
        f = dict(alpha=None, image=None, size=None, lossless=False,
                 offset=(0, 0))
        while True:
            tag, size, padded = chunk(pos)
            if tag == b"ALPH" and f["alpha"] is None:
                f["alpha"] = (pos + 8, size)
            elif tag == b"VP8L" and f["alpha"] is not None:
                fail("an ALPH chunk before a VP8L frame")
            elif tag in (b"VP8 ", b"VP8L") and f["image"] is None:
                f["size"] = features(pos, tag, size, padded)
                f["image"] = (pos + 8, padded)
                f["lossless"] = tag == b"VP8L"
            else:
                return pos, f  # a chunk of the level above
            pos += 8 + padded
            if pos == end:
                return pos, f
            if end - pos < 8:
                fail("truncated file")

    frames = []
    state = dict(flags=0, canvas=None, anim=0)

    def single_image(pos: int) -> int:
        if frames:
            fail("more than one image")
        if end - pos < 8:
            fail("truncated file")
        pos, f = store_frame(pos, 0)
        if not state["flags"] & _WEBP_ALPHA:
            f["alpha"] = None  # the demuxer drops ALPH without the flag
        if state["canvas"] is None and f["size"] is not None:
            state["canvas"] = f["size"]
        frames.append(f)
        return pos

    animated = False
    if head[12:16] == b"VP8X":
        (size,) = struct.unpack("<I", head[16:20])
        if size > _WEBP_MAX_PAYLOAD or size < 10:
            fail(f"bad VP8X chunk size {size}")
        size += size & 1
        if size > end - 20:
            fail("the VP8X chunk runs past the RIFF chunk")
        vp8x = read(20, 10)
        state["flags"] = vp8x[0]
        state["canvas"] = (_le24(vp8x[4:7]) + 1, _le24(vp8x[7:10]) + 1)
        if state["canvas"][0] * state["canvas"][1] >= _WEBP_MAX_AREA:
            fail("the canvas is too large")
        animated = bool(state["flags"] & _WEBP_ANIMATION)
        pos = 20 + size
        if end - pos < 8:
            fail("truncated file (nothing after VP8X)")
        while True:
            tag, size, padded = chunk(pos)
            if tag == b"VP8X":
                fail("a second VP8X chunk")
            elif tag in (b"ALPH", b"VP8 ", b"VP8L"):
                if state["anim"] or animated:
                    fail(f"a {tag!r} chunk outside ANMF in an animation")
                pos = single_image(pos)
            elif tag == b"ANIM":
                if padded < 6:
                    fail("bad ANIM chunk size")
                state["anim"] = 1
                pos += 8 + padded
            elif tag == b"ANMF":
                if not state["anim"]:
                    fail("an ANMF chunk before ANIM")
                if padded < 16:
                    fail("bad ANMF chunk size")
                hdr = read(pos + 8, 16)
                x, y = 2 * _le24(hdr[0:3]), 2 * _le24(hdr[3:6])
                if (_le24(hdr[6:9]) + 1) * (_le24(hdr[9:12]) + 1) >= \
                        _WEBP_MAX_AREA:
                    fail("an ANMF frame is too large")
                start = pos + 24
                pos, f = store_frame(start, padded - 16)
                if pos - start > padded - 16:
                    fail("an ANMF frame's chunks run past it")
                if animated and (f["alpha"] or f["image"]):
                    if frames and frames[-1]["image"] is None:
                        fail("an incomplete frame")
                    f["offset"] = (x, y)
                    frames.append(f)
            else:
                pos += 8 + padded
            if pos == end:
                break
            if end - pos < 8:
                fail("truncated file")
        if state["flags"] & ~_WEBP_FLAGS & 0xFF:
            fail("reserved VP8X flags set")
    else:
        single_image(12)
    if not frames:
        fail("no image")
    cw, ch = state["canvas"]
    for f in frames:
        if f["image"] is None:
            fail("a frame without an image chunk")
        (x, y), (w, h) = f["offset"], f["size"]
        if not animated and ((x, y) != (0, 0) or (w, h) != (cw, ch)):
            fail(f"the frame is {w}x{h}, the canvas {cw}x{ch}")
        if x + w > cw or y + h > ch:
            fail(f"a {w}x{h} frame at ({x}, {y}) is off the {cw}x{ch} "
                 "canvas")
    f = frames[0]
    return WebPLayout((cw, ch), f["offset"], f["size"], f["lossless"],
                      f["image"], f["alpha"])


def _webp_size(path, f) -> tuple:
    size = f.seek(0, io.SEEK_END)

    def read(offset: int, n: int) -> bytes:
        f.seek(offset)
        return f.read(n)
    return webp_layout(path, read, size).canvas


def read_webp(path, blob: bytes, info: dict = None) -> tuple:
    """The WebP file ``blob`` (read from ``path``) as Pillow's
    ``WebPAnimDecoder`` gives its first frame: (HxWx3 RGB, HxW alpha) of
    the canvas; ``info`` receives what the frame used
    (``native.WEBP_INFO``)."""
    lay = webp_layout(path, lambda o, n: blob[o:o + n], len(blob))
    _check_pixels(path, lay.canvas)
    (start, length), alpha = lay.image, None
    if lay.alpha is not None:
        alpha = blob[lay.alpha[0]:lay.alpha[0] + lay.alpha[1]]
    rgb, a = native.webp_decode(blob[start:start + length], lay.lossless,
                                alpha, lay.size, path, info)
    if lay.size == lay.canvas:
        return rgb, a
    (cw, ch), (x, y), (w, h) = lay.canvas, lay.offset, lay.size
    full, fa = np.zeros((ch, cw, 3), np.uint8), np.zeros((ch, cw), np.uint8)
    full[y:y + h, x:x + w], fa[y:y + h, x:x + w] = rgb, a
    return full, fa


def _png_size(path, f) -> tuple:
    """(width, height) from the PNG ``f``'s IHDR chunk, as Pillow's PNG
    reader finds it: the chunks up to IHDR, each with its CRC checked.
    What that reader refuses there raises ``ImageRefused``: a chunk type
    not of four word characters, a short chunk, a bad CRC, IEND before
    IHDR, and in IHDR a length under 13, a filter method
    other than 0, no mode for its bit depth and color type, or a side of
    0."""
    f.seek(8)
    while True:
        head = f.read(8)
        if len(head) < 8:
            why = "no IHDR chunk"
            break
        n, kind = struct.unpack(">I4s", head)
        data, crc = f.read(n), f.read(4)
        if not kind.replace(b"_", b"a").isalnum():  # ASCII \w{4}
            why = f"a chunk type {kind!r}"
        elif kind == b"IEND":
            why = "an IEND chunk before IHDR"
        elif kind == b"IDAT":  # Pillow takes a size from a later IHDR
            raise UnsupportedImage(f"{path}: a PNG file with an IDAT "
                                   "chunk before IHDR")
        elif len(data) < n or len(crc) < 4:
            why = f"a truncated {kind!r} chunk"
        elif kind == b"IHDR" and n < 13:
            why = "a truncated IHDR chunk"
        elif zlib.crc32(kind + data) != struct.unpack(">I", crc)[0]:
            why = f"a bad CRC in a {kind!r} chunk"
        elif kind != b"IHDR":
            continue
        else:
            w, h, depth, color, _, filt, _ = struct.unpack(">IIBBBBB",
                                                          data[:13])
            if filt:
                why = f"filter method {filt}"
            elif (depth, color) not in _PNG_MODES:
                why = f"bit depth {depth} with color type {color}"
            elif not w or not h:
                why = f"a {w}x{h} image"
            else:
                return w, h
        break
    raise ImageRefused(f"{path}: {why} (Pillow cannot identify the file)")


def _size(path, f) -> tuple:
    """(format, (width, height)) from the headers of the file ``f``,
    checked against the decompression-bomb limit."""
    kind = _format(path, f.read(16))
    if kind == "png":
        size = _png_size(path, f)
    elif kind == "webp":
        size = _webp_size(path, f)
    else:
        f.seek(2)
        size = _jpeg_size(path, f)
    return kind, _check_pixels(path, size)


def read_image_size(path) -> tuple:
    """(width, height) as Pillow's ``Image.open(path).size``, from the
    headers."""
    with open(path, "rb") as f:
        return _size(path, f)[1]


def _read(path, mode: str) -> np.ndarray:
    blob = Path(path).read_bytes()
    kind, size = _size(path, io.BytesIO(blob))
    if kind == "png":
        return png.read_png_as(path, mode)
    if kind == "webp":
        rgb = read_webp(path, blob)[0]
        return png.to_gray(rgb) if mode == "L" else rgb
    return native.jpeg_decode(blob, size, mode == "L", path)


def read_rgb(path) -> np.ndarray:
    """Pillow's ``Image.open(path).convert("RGB")``: HxWx3 uint8."""
    return _read(path, "RGB")


def read_gray(path) -> np.ndarray:
    """Pillow's ``Image.open(path).convert("L")``: HxW uint8."""
    return _read(path, "L")
