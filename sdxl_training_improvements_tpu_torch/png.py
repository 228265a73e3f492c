"""PNG files with the standard library and numpy.

The card's machine has no Pillow, so ``generate.py`` writes and reads PNGs
here: ``write_png`` writes 8-bit gray or RGB (filter 0 on every row,
zlib); ``read_png`` reads non-interlaced 8-bit gray, gray+alpha, RGB and
RGBA with any of the five row filters.  ``to_rgb`` and ``to_gray`` convert
as Pillow's ``convert("RGB")`` / ``convert("L")`` do (alpha dropped, not
composited; ITU-R 601-2 luma in 16-bit fixed point).
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels (0 gray, 2 RGB, 4 gray + alpha, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def write_png(path, image: np.ndarray) -> None:
    """HxW (gray) or HxWx3 (RGB) uint8 -> an 8-bit PNG at ``path``."""
    a = np.asarray(image)
    if a.dtype != np.uint8 or not (a.ndim == 2 or (a.ndim == 3
                                                   and a.shape[2] == 3)):
        raise ValueError(f"write_png takes HxW or HxWx3 uint8, got "
                         f"{a.dtype} {a.shape}")
    h, w = a.shape[:2]
    rows = np.ascontiguousarray(a).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if a.ndim == 2 else 2, 0, 0, 0)
    Path(path).write_bytes(
        _SIGNATURE + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The PNG row filters undone: [h, stride] uint8."""
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


def read_png(path) -> np.ndarray:
    """An 8-bit, non-interlaced PNG -> uint8 HxW (gray) or HxWxC (gray +
    alpha, RGB, RGBA).  Palette images, other bit depths and interlacing
    raise."""
    blob = Path(path).read_bytes()
    if not blob.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = len(_SIGNATURE), None, []
    while pos + 8 <= len(blob):
        n, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + data) != struct.unpack(
                ">I", blob[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"{path}: bad CRC in a {kind!r} chunk")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(
            f"{path}: bit depth {depth}, color type {color}, interlace "
            f"{interlace}: only non-interlaced 8-bit gray, gray+alpha, RGB "
            "and RGBA are read")
    c = _CHANNELS[color]
    out = _unfilter(zlib.decompress(b"".join(idat)), h, w * c, c)
    return out.reshape(h, w) if c == 1 else out.reshape(h, w, c)


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
