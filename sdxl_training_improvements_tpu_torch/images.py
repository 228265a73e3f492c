"""Image files as the JAX package reads them with Pillow, without Pillow.

The card's machine has no Pillow, so the port reads images here, for the
dataset's bucketing and precompute and for ``generate.py --init/--mask``:

* ``read_rgb(path)`` is ``Image.open(path).convert("RGB")`` as an HxWx3
  uint8 array, ``read_gray(path)`` is ``convert("L")`` (HxW), and
  ``read_image_size(path)`` is ``.size`` (width, height) from the
  headers alone: the frame header (SOFn) of a JPEG, IHDR of a PNG.
* The format is told by the file's leading bytes, as Pillow tells it,
  not by its extension.
* JPEG: baseline, extended-sequential and progressive Huffman frames, 1,
  3 or 4 components, decoded in C++ (``native/jpeg_decode.cpp``) to
  Pillow's bits.  Refused, raising ``ValueError`` naming the file and
  the reason: arithmetic coding, 12-bit, lossless and hierarchical
  frames, a height set by a DNL marker, progressive scans that leave
  low coefficients unrefined, and truncated or corrupt streams.  Pillow
  decodes arithmetic-coded and some damaged files that the port refuses.
* PNG: every color type and bit depth, Adam7 included (``png.py``).
* WebP, GIF and any other format raise, naming the file and the format.
  EXIF orientation, ICC profiles and comments are ignored, as
  ``convert`` ignores them.
"""
from __future__ import annotations

import io
import struct
from pathlib import Path

import numpy as np

from sdxl_training_improvements_tpu_torch import native, png

# JPEG frame markers: the three the decoder reads, and what the others are
_JPEG_FRAMES = {0xC0, 0xC1, 0xC2}
_JPEG_REFUSED = {0xC3: "lossless", 0xC5: "hierarchical",
                 0xC6: "hierarchical", 0xC7: "hierarchical",
                 0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded",
                 0xCB: "arithmetic-coded", 0xCD: "hierarchical "
                 "arithmetic-coded", 0xCE: "hierarchical arithmetic-coded",
                 0xCF: "hierarchical arithmetic-coded"}
# markers without a length field
_JPEG_BARE = {0x01, *range(0xD0, 0xD9)}


def _format(path, head: bytes) -> str:
    """"jpeg" or "png" from a file's first bytes; others raise."""
    if head.startswith(b"\xff\xd8\xff"):
        return "jpeg"
    if head.startswith(png._SIGNATURE):
        return "png"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        kind = "a WebP image"
    elif head[:6] in (b"GIF87a", b"GIF89a"):
        kind = "a GIF image"
    else:
        kind = "not a JPEG or PNG file"
    raise ValueError(f"{path}: {kind} (the port reads JPEG and PNG images "
                     "only)")


def _jpeg_size(path, f) -> tuple:
    """(width, height) from the frame header of the JPEG read from ``f``
    (just past its SOI); frames the decoder does not read raise."""
    def read(n: int) -> bytes:
        b = f.read(n)
        if len(b) < n:
            raise ValueError(f"{path}: truncated file (no frame header)")
        return b
    while True:
        if read(1) != b"\xff":
            continue  # bytes that are not a marker are skipped
        m = read(1)[0]
        while m == 0xFF:
            m = read(1)[0]
        if m == 0 or m in _JPEG_BARE:
            continue
        if m in (0xDA, 0xD9):
            raise ValueError(f"{path}: corrupt data (no frame header)")
        (n,) = struct.unpack(">H", read(2))
        if n < 2:
            raise ValueError(f"{path}: corrupt data (bad marker length)")
        if m in _JPEG_REFUSED:
            raise ValueError(f"{path}: {_JPEG_REFUSED[m]} JPEG (not "
                             "supported)")
        if m not in _JPEG_FRAMES:
            read(n - 2)
            continue
        precision, h, w, comps = struct.unpack(">BHHB", read(6))
        if precision != 8:
            raise ValueError(f"{path}: {precision}-bit samples (only "
                             "8-bit JPEGs are read)")
        if h == 0:
            raise ValueError(f"{path}: the height is set by a DNL marker "
                             "(not supported)")
        if comps not in (1, 3, 4):
            raise ValueError(f"{path}: cannot handle {comps}-component "
                             "images")
        return w, h


def read_image_size(path) -> tuple:
    """(width, height) as Pillow's ``Image.open(path).size``, from the
    headers."""
    with open(path, "rb") as f:
        head = f.read(12)
        kind = _format(path, head)
        if kind == "png":
            return png.read_png_size(path)
        f.seek(2)
        return _jpeg_size(path, f)


def _read(path, mode: str) -> np.ndarray:
    blob = Path(path).read_bytes()
    if _format(path, blob[:12]) == "png":
        return png.read_png_as(path, mode)
    size = _jpeg_size(path, io.BytesIO(blob[2:]))
    return native.jpeg_decode(blob, size, mode == "L", path)


def read_rgb(path) -> np.ndarray:
    """Pillow's ``Image.open(path).convert("RGB")``: HxWx3 uint8."""
    return _read(path, "RGB")


def read_gray(path) -> np.ndarray:
    """Pillow's ``Image.open(path).convert("L")``: HxW uint8."""
    return _read(path, "L")
