"""PNG files with the standard library and numpy.

The card's machine has no Pillow, so ``generate.py``, ``serve.py`` and
the dataset write and read PNGs here: ``encode_png`` makes the bytes of an
8-bit gray or RGB PNG (filter 0 on every row, zlib) and ``write_png``
writes them; ``read_png`` reads every color type (gray, RGB, palette,
gray+alpha, RGBA) at every bit depth PNG allows (1-16), Adam7 files
too (each pass unfiltered on its own), with the five row filters undone
in C++ (``native.png_unfilter``; ``_unfilter`` is its plain numpy/Python
version, which the tests hold it against byte for byte), and gives the
samples as stored; ``read_png_as`` gives what Pillow's ``convert("RGB")``
or ``convert("L")`` makes of them (``images.py`` reads a PNG's size
from its headers).  ``to_rgb`` and ``to_gray`` convert
as Pillow's ``convert("RGB")`` / ``convert("L")`` do (alpha dropped, not
composited; ITU-R 601-2 luma in 16-bit fixed point).  ``resize_lanczos``
and ``resize_nearest`` give what Pillow's ``Image.resize(size,
Image.LANCZOS)`` and ``Image.resize(size, Image.NEAREST)`` give, bit for
bit (``_Resample.c``'s two separable passes with 22-bit fixed-point
coefficients, ``Geometry.c``'s nearest scaling).
"""
from __future__ import annotations

import math
import struct
import zlib
from pathlib import Path

import numpy as np

from sdxl_training_improvements_tpu_torch import native

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels (0 gray, 2 RGB, 3 palette, 4 gray + alpha, 6
# RGBA), and the bit depths each may have
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7: each pass's first column and row and its steps (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode_png(image: np.ndarray) -> bytes:
    """HxW (gray) or HxWx3 (RGB) uint8 -> the bytes of an 8-bit PNG."""
    a = np.asarray(image)
    if a.dtype != np.uint8 or not (a.ndim == 2 or (a.ndim == 3
                                                   and a.shape[2] == 3)):
        raise ValueError(f"encode_png takes HxW or HxWx3 uint8, got "
                         f"{a.dtype} {a.shape}")
    h, w = a.shape[:2]
    rows = np.ascontiguousarray(a).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if a.ndim == 2 else 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path, image: np.ndarray) -> None:
    """HxW (gray) or HxWx3 (RGB) uint8 -> an 8-bit PNG at ``path``."""
    Path(path).write_bytes(encode_png(image))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The PNG row filters undone: [h, stride] uint8 (the plain version of
    ``native.png_unfilter``)."""
    if len(data) != h * (stride + 1):
        raise ValueError(f"PNG data is {len(data)} bytes, expected "
                         f"{h * (stride + 1)}")
    rows = np.frombuffer(data, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum per byte of the pixel
            cur = (np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0)
                   % 256).astype(np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: byte by byte
            cur = bytearray(line.tobytes())
            up = prior.tolist()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = cur
        prior = out[y]
    return out


def _chunks(path) -> tuple:
    """(IHDR fields, the IDAT data joined, the PLTE entries or None) of
    the PNG at ``path``; every chunk's CRC is checked."""
    blob = Path(path).read_bytes()
    if not blob.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat, plte = len(_SIGNATURE), None, [], None
    while pos + 8 <= len(blob):
        n, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + n]
        crc = blob[pos + 8 + n:pos + 12 + n]
        if len(crc) < 4 or zlib.crc32(kind + data) != struct.unpack(
                ">I", crc)[0]:
            raise ValueError(f"{path}: bad CRC in a {kind!r} chunk")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            plte = np.frombuffer(data, np.uint8)[:len(data) // 3 * 3
                                                 ].reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    try:
        data = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from None
    return header, data, plte


def _unpack(rows: np.ndarray, w: int, c: int, depth: int) -> np.ndarray:
    """Unfiltered rows [h, stride] -> samples [h, w, c]: uint8 for depths
    up to 8 (the values as stored), uint16 for 16."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2")[:, :w * c].astype(np.uint16).reshape(h, w, c)
    if depth == 8:
        return rows[:, :w * c].reshape(h, w, c)
    bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[..., None]


def _decode(path) -> tuple:
    """(samples [h, w, c] as ``_unpack`` gives them, color type, bit
    depth, PLTE entries or None) of the PNG at ``path``."""
    header, data, plte = _chunks(path)
    w, h, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in _DEPTHS[color] or \
            interlace > 1:
        raise ValueError(f"{path}: bit depth {depth}, color type {color}, "
                         f"interlace {interlace}: not a valid PNG")
    if color == 3 and plte is None:
        raise ValueError(f"{path}: a palette image without a PLTE chunk")
    c = _CHANNELS[color]
    bpp = max(1, c * depth // 8)  # the filters' left-neighbour distance
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    out = np.zeros((h, w, c), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:  # an empty pass has no bytes at all
            continue
        stride = -(-(pw * c * depth) // 8)
        n = ph * (stride + 1)
        if interlace and pos + n > len(data):
            raise ValueError(f"{path}: truncated image data")
        part = data[pos:pos + n] if interlace else data
        rows = native.png_unfilter(part, ph, stride, bpp)
        out[y0::dy, x0::dx] = _unpack(rows, pw, c, depth)
        pos += n
    return out, color, depth, plte


def read_png(path) -> np.ndarray:
    """A PNG's samples as stored: HxW (one channel: gray or palette
    indices) or HxWxC (gray + alpha, RGB, RGBA); uint8 for bit depths up
    to 8 (a 1-, 2- or 4-bit sample keeps its value), uint16 for 16;
    Adam7 files de-interlaced."""
    samples, _, _, _ = _decode(path)
    return samples[..., 0] if samples.shape[2] == 1 else samples


def read_png_as(path, mode: str) -> np.ndarray:
    """What Pillow's ``Image.open(path).convert(mode)`` gives, ``mode``
    "RGB" (HxWx3) or "L" (HxW), by Pillow's rules: 1-, 2- and 4-bit
    gray scale to 0-255 (times 255, 85, 17: modes "1", "L;2", "L;4");
    16-bit gray (mode "I;16") clips at 255 rather than scaling; every
    other 16-bit channel keeps its high byte ("RGB;16B" and the like);
    a palette index takes its PLTE entry, and an index past the PLTE's
    end black; tRNS and alpha are dropped, not composited."""
    samples, color, depth, plte = _decode(path)
    if depth == 16:
        a = (np.minimum(samples, 255) if color == 0 else samples >> 8
             ).astype(np.uint8)
    elif color == 3:
        table = np.zeros((256, 3), np.uint8)
        table[:len(plte)] = plte[:256]
        a = table[samples[..., 0]]
    elif depth < 8:
        a = samples * np.uint8({1: 255, 2: 85, 4: 17}[depth])
    else:
        a = samples
    if a.shape[-1] == 1:
        a = a[..., 0]
    if mode == "RGB":
        return to_rgb(a)
    if mode == "L":
        return to_gray(a)
    raise ValueError(f"mode {mode!r}: only 'RGB' and 'L'")


def to_rgb(a: np.ndarray) -> np.ndarray:
    """uint8 gray, gray+alpha, RGB or RGBA -> HxWx3 (alpha dropped)."""
    if a.ndim == 2:
        return np.repeat(a[..., None], 3, axis=2)
    if a.shape[2] in (1, 2):
        return np.repeat(a[..., :1], 3, axis=2)
    return np.ascontiguousarray(a[..., :3])


def to_gray(a: np.ndarray) -> np.ndarray:
    """uint8 image -> HxW luma, (R*19595 + G*38470 + B*7471 + 2^15) >> 16
    as Pillow's ``convert("L")`` computes it."""
    if a.ndim == 2:
        return a
    if a.shape[2] in (1, 2):
        return a[..., 0]
    r, g, b = (a[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


# Pillow's 8-bit resampling: coefficients in fixed point with this many
# fraction bits, and the rounding constant every sum starts from
_PRECISION_BITS = 32 - 8 - 2
_LANCZOS_SUPPORT = 3.0


def _lanczos(x: float) -> float:
    def sinc(v):
        if v == 0.0:
            return 1.0
        v = v * math.pi
        return math.sin(v) / v

    return sinc(x) * sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


def _lanczos_coeffs(in_size: int, out_size: int):
    """(first input index [out], fixed-point weights [out, ksize] int64) of
    one axis, as ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` make
    them; weights past a window's end are 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _LANCZOS_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    one = 1 << _PRECISION_BITS
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        for x, v in enumerate(w):
            v = v / ww if ww != 0.0 else v
            kk[xx, x] = int(-0.5 + v * one) if v < 0 else int(0.5 + v * one)
        first[xx] = xmin
    return first, kk


def _resample_axis(a: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One Lanczos pass of uint8 ``a`` along ``axis`` (0 rows, 1 columns),
    clipped to uint8 as Pillow's ``clip8`` does."""
    in_size = a.shape[axis]
    first, kk = _lanczos_coeffs(in_size, out_size)
    src = a.astype(np.int64)
    acc = np.full((out_size,) + a.shape[1:] if axis == 0
                  else (a.shape[0], out_size) + a.shape[2:],
                  1 << (_PRECISION_BITS - 1), np.int64)
    shape = [1] * a.ndim
    shape[axis] = out_size
    for t in range(kk.shape[1]):
        idx = np.minimum(first + t, in_size - 1)  # weight 0 past the end
        acc += np.take(src, idx, axis=axis) * kk[:, t].reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_lanczos(image: np.ndarray, width: int, height: int
                   ) -> np.ndarray:
    """HxWx3 (or HxW) uint8 -> height x width, as Pillow's
    ``Image.resize((width, height), Image.LANCZOS)``: the horizontal pass
    first, then the vertical, each skipped where that side keeps its
    size."""
    a = np.asarray(image)
    if a.dtype != np.uint8:
        raise ValueError(f"resize_lanczos takes uint8, got {a.dtype}")
    if a.shape[1] != width:
        a = _resample_axis(a, width, axis=1)
    if a.shape[0] != height:
        a = _resample_axis(a, height, axis=0)
    return np.ascontiguousarray(a)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Input index of each output pixel along one axis
    (``ImagingScaleAffine``: a running double sum from the first pixel's
    center, truncated)."""
    step = in_size / out_size
    pos, idx = step * 0.5, np.zeros(out_size, np.int64)
    for x in range(out_size):
        idx[x] = int(pos)
        pos += step
    return idx


def resize_nearest(image: np.ndarray, width: int, height: int
                   ) -> np.ndarray:
    """HxW (or HxWxC) uint8 -> height x width, as Pillow's
    ``Image.resize((width, height), Image.NEAREST)``."""
    a = np.asarray(image)
    return a[_nearest_index(a.shape[0], height)][
        :, _nearest_index(a.shape[1], width)]
