"""Native (C++) image library: built by g++ at first use, bound by ctypes.

``prepare_image_native`` fuses Lanczos3 resize -> crop -> flip -> [-1, 1]
float32 CHW in OpenMP-parallel C++ (``image_ops.cpp``, the JAX package's
arithmetic, so both packages prepare an image to the same bits);
``png_unfilter`` undoes the PNG row filters for ``png.read_png``;
``jpeg_decode`` decodes a JPEG as Pillow's libjpeg-turbo does
(``jpeg_decode.cpp``: Huffman, arithmetic and lossless frames, damaged
streams recovered from, block smoothing; a library of its own, built
without OpenMP: the precompute decodes one image a thread); ``webp_decode`` decodes one WebP frame as Pillow's
libwebp does (``webp_decode.cpp``, built the same way).

Each library is compiled into the package's ``_build/`` directory, named
by its source's name and a hash of the source and the flags; one thread
of a process builds (the precompute's decode threads reach it together on
a cold checkout), and processes build under their own temporary names.
The calls release the GIL (ctypes does for a ``CDLL``), so the decode
threads run at once.  The JAX package falls back to PIL when the build
fails; the port has no such fallback (the card's machine has no Pillow),
so a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "image_ops.cpp"
_JPEG_SRC = Path(__file__).resolve().parent / "jpeg_decode.cpp"
_WEBP_SRC = Path(__file__).resolve().parent / "webp_decode.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
# the image decoders: no OpenMP (the precompute decodes one image a thread)
DECODER_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_BUILD_LOCK = threading.Lock()

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_INTP = ctypes.POINTER(ctypes.c_int)


def build(src: Path = _SRC, flags=FLAGS) -> Path:
    """The shared library of ``src``, compiled unless an up-to-date one
    exists."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()
                            ).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    with _BUILD_LOCK:
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *flags, str(src), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {src}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.prepare_image.restype = ctypes.c_int
    lib.prepare_image.argtypes = [
        _U8P, ctypes.c_int, ctypes.c_int,  # src, sh, sw
        _F32P, ctypes.c_int, ctypes.c_int,  # dst, th, tw
        ctypes.c_int, ctypes.c_int,  # crop_top, crop_left
        ctypes.c_int, ctypes.c_int,  # rh, rw
        ctypes.c_int,  # flip
    ]
    lib.png_unfilter.restype = ctypes.c_int
    lib.png_unfilter.argtypes = [_U8P, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, _U8P, _INTP]
    return lib


def prepare_image_native(rgb: np.ndarray, target_h: int, target_w: int,
                         crop_top: int, crop_left: int, resized_h: int,
                         resized_w: int, flip: bool = False) -> np.ndarray:
    """uint8 HWC RGB -> float32 CHW in [-1, 1]: resized to (resized_h,
    resized_w), the (target_h, target_w) window at (crop_top, crop_left),
    mirrored when ``flip``."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected HWC RGB uint8, got {rgb.shape}")
    sh, sw = rgb.shape[:2]
    out = np.empty((3, target_h, target_w), dtype=np.float32)
    rc = load().prepare_image(
        rgb.ctypes.data_as(_U8P), sh, sw, out.ctypes.data_as(_F32P),
        target_h, target_w, crop_top, crop_left, resized_h, resized_w,
        int(flip))
    if rc != 0:
        raise ValueError(f"prepare_image failed with code {rc} (source "
                         f"{sh}x{sw}, resized {resized_h}x{resized_w}, "
                         f"crop {target_h}x{target_w} at ({crop_top}, "
                         f"{crop_left}))")
    return out


def png_unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The PNG row filters of ``data`` (h rows of a filter byte and
    ``stride`` bytes) undone: [h, stride] uint8."""
    if len(data) != h * (stride + 1):
        raise ValueError(f"PNG data is {len(data)} bytes, expected "
                         f"{h * (stride + 1)}")
    src = np.frombuffer(data, np.uint8)
    out = np.empty((h, stride), np.uint8)
    bad = ctypes.c_int(-1)
    rc = load().png_unfilter(src.ctypes.data_as(_U8P), h, stride, bpp,
                             out.ctypes.data_as(_U8P), ctypes.byref(bad))
    if rc != 0:
        row = bad.value
        raise ValueError(f"PNG row {row}: unknown filter type "
                         f"{src[row * (stride + 1)]}")
    return out


@functools.lru_cache(maxsize=None)
def load_jpeg() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(_JPEG_SRC, DECODER_FLAGS)))
    lib.jpeg_decode.restype = ctypes.c_int
    lib.jpeg_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,  # data, n, gray
        _U8P, ctypes.c_size_t,  # out, its bytes
        _INTP, _INTP,  # width, height
        ctypes.c_char_p, ctypes.c_int]  # message, its room
    return lib


def jpeg_decode(blob: bytes, size: tuple, gray: bool, name) -> np.ndarray:
    """The JPEG ``blob`` of ``size`` (width, height) decoded as Pillow's
    ``convert("L")`` (``gray``: HxW) or ``convert("RGB")`` (HxWx3) gives
    it; a file the decoder refuses raises ``ValueError`` naming ``name``
    and the reason."""
    w, h = size
    out = np.empty((h, w) if gray else (h, w, 3), np.uint8)
    got_w, got_h = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    rc = load_jpeg().jpeg_decode(blob, len(blob), int(gray),
                                 out.ctypes.data_as(_U8P), out.nbytes,
                                 ctypes.byref(got_w), ctypes.byref(got_h),
                                 err, len(err))
    if rc == 1:
        raise ValueError(f"{name}: {err.value.decode()}")
    if rc != 0 or (got_w.value, got_h.value) != (w, h):
        raise ValueError(f"{name}: the frame is {got_w.value}x{got_h.value}"
                         f", the header said {w}x{h}")
    return out


@functools.lru_cache(maxsize=None)
def load_webp() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(_WEBP_SRC, DECODER_FLAGS)))
    lib.webp_decode.restype = ctypes.c_int
    lib.webp_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,  # data, n, lossless
        ctypes.c_char_p, ctypes.c_size_t,  # ALPH payload, its bytes
        _U8P, ctypes.c_size_t, _U8P,  # out, its bytes, alpha out
        _INTP, _INTP, _INTP,  # width, height, info
        ctypes.c_char_p, ctypes.c_int]  # message, its room
    return lib


# what ``webp_decode``'s ``info`` holds (webp_decode.cpp lists them)
WEBP_INFO = ("lossless", "transforms", "cache_bits", "entropy_image",
             "palette", "filter_type", "filter_level", "sharpness",
             "partitions", "segments", "segment_map", "alpha_method",
             "alpha_filter", "alpha_transforms", "bpred_mbs", "skip_flags")


def webp_decode(payload: bytes, lossless: bool, alpha, size: tuple,
                name, info: dict = None) -> tuple:
    """One WebP frame of ``size`` (width, height), decoded as Pillow's
    libwebp decodes it: (HxWx3 RGB, HxW alpha).  ``payload`` is its
    ``VP8L`` (``lossless``) or ``VP8 `` chunk's payload, ``alpha`` its
    ``ALPH`` chunk's payload or None.  ``info``, when given, receives what
    the frame used (``WEBP_INFO``).  A frame the decoder refuses raises
    ``ValueError`` naming ``name`` and the reason."""
    w, h = size
    out = np.empty((h, w, 3), np.uint8)
    a = np.empty((h, w), np.uint8)
    got_w, got_h = ctypes.c_int(), ctypes.c_int()
    used = (ctypes.c_int * len(WEBP_INFO))()
    err = ctypes.create_string_buffer(256)
    rc = load_webp().webp_decode(
        payload, len(payload), int(lossless), alpha,
        0 if alpha is None else len(alpha), out.ctypes.data_as(_U8P),
        out.nbytes, a.ctypes.data_as(_U8P), ctypes.byref(got_w),
        ctypes.byref(got_h), used, err, len(err))
    if rc == 1:
        raise ValueError(f"{name}: {err.value.decode()}")
    if rc != 0 or (got_w.value, got_h.value) != (w, h):
        raise ValueError(f"{name}: the frame is {got_w.value}x{got_h.value}"
                         f", the header said {w}x{h}")
    if info is not None:
        info.update(zip(WEBP_INFO, used))
    return out, a
