"""Write the JPEG and WebP fixtures of ``tests/fixtures/images/`` and their
manifest.

    python tools/make_image_fixtures.py   # needs Pillow (not the card's machine)

* ``entry_*.jpg``: the four JPEGs of ``chip_smoke.py``'s phase 11, at
  its bucket sizes (1024x1024 and 1216x832) with smooth content:
  baseline 4:2:0 with restart markers, progressive 4:2:0, baseline
  4:4:4 and grayscale.
* ``m_*.jpg``: small files over the decode matrix.  Pillow writes the
  common ones; the rest come from ``encode_baseline`` below, a plain
  baseline encoder (float DCT, fixed-length Huffman codes) that can set
  what Pillow's encoder cannot: any sampling factors, one scan per
  component, the Adobe marker's RGB and YCCK transforms, a grayscale
  component sampled 2x2.
* ``entry_*.webp``: the two WebPs of phase 11: lossy with alpha at
  1024x1024 and lossless at 1216x832 (its content posterized to steps of
  8, which keeps it small).
* ``w_*.webp``: small WebPs over the decode matrix, odd and even sizes.
  Pillow writes lossy files at a few qualities and methods, with and
  without alpha, lossless ones at 2, 4, 16 and 256 colors (color
  indexing) and photo-like ones (predictor, cross-color, subtract-green,
  color cache, entropy image), and a VP8X file with ICC, EXIF and XMP
  chunks.  What Pillow's ``save`` cannot set comes from libwebp's own
  encoder (``WebPEncode`` of the ``libwebp`` Pillow bundles, through
  ctypes): the simple loop filter, sharpness 1-7, 2, 4 and 8 token
  partitions, one segment, the filter off.  The ALPH chunks of each
  method (raw, lossless) and filter (none, horizontal, vertical,
  gradient) and an animation whose first frame is smaller than its
  canvas and offset on it are put together here from those encoders'
  bitstreams.
* ``manifest.json``: each file's size and the sha256 of Pillow's
  ``convert("RGB")`` and ``convert("L")`` bytes, with Pillow's,
  libjpeg-turbo's and libwebp's versions.
  ``tests/test_torch_image_decode.py`` (JPEG) and
  ``tests/test_torch_webp.py`` hold it equal to Pillow's decode of the
  committed bytes and to the port's; ``chip_smoke.py`` holds the port's
  decode on the card's host to it.
"""
import ctypes
import hashlib
import io
import json
import math
import struct
from pathlib import Path

import numpy as np
import PIL
from PIL import Image, features

OUT = Path(__file__).resolve().parent.parent / "tests" / "fixtures" / "images"
ENTRY_SIZES = ((1024, 1024), (1216, 832))  # chip_smoke.ENTRY_IMAGE_SIZES
WEBP_ENTRY = ("entry_lossy_alpha.webp", "entry_lossless.webp")

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def smooth(w: int, h: int, channels: int, seed: int) -> np.ndarray:
    """A photo-like HxWxC uint8 image of low frequencies only (it stays
    small as a JPEG): gradients plus a few seeded sinusoids."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / max(w, h)
    out = []
    for _ in range(channels):
        v = 96 + 80 * (rng.uniform(-1, 1) * x + rng.uniform(-1, 1) * y)
        for _ in range(3):
            fx, fy = rng.uniform(1, 6, 2)
            v += 20 * np.sin(2 * math.pi * (fx * x + fy * y)
                             + rng.uniform(0, 2 * math.pi))
        out.append(v)
    return np.clip(np.stack(out, -1), 0, 255).round().astype(np.uint8)


def _segment(marker: int, data: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(data) + 2) + data


class _Bits:
    """MSB-first bits with 0xFF stuffing."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self) -> bytes:  # pad the last byte with 1-bits
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        out, self.out = bytes(self.out), bytearray()
        return out


def _dct_matrix() -> np.ndarray:
    c = np.array([[math.cos((2 * x + 1) * u * math.pi / 16)
                   for x in range(8)] for u in range(8)])
    c[0] *= 1 / math.sqrt(2)
    return c / 2


def _blocks(plane: np.ndarray, bw: int, bh: int) -> np.ndarray:
    """[bh, bw, 8, 8] blocks of ``plane``, its edges repeated out to
    bw*8 x bh*8."""
    h, w = plane.shape
    p = np.pad(plane, ((0, bh * 8 - h), (0, bw * 8 - w)), mode="edge")
    return p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)


def encode_baseline(planes, factors, ids=None, quality_table=None,
                    interleaved=True, restart=0, jfif=True, adobe=None,
                    width=None, height=None) -> bytes:
    """A baseline JPEG of ``planes`` (each component's samples, already
    at its sampled size) with sampling ``factors`` [(h, v), ...]: one
    interleaved scan or one scan a component, a restart interval of
    ``restart`` MCUs, the JFIF marker and/or an Adobe marker with
    transform ``adobe``.  Huffman codes are fixed-length (4 bits for DC
    categories, 8 for AC symbols), so any data fits."""
    n = len(planes)
    ids = ids or list(range(1, n + 1))
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    q = (np.asarray(quality_table) if quality_table is not None
         else np.full(64, 4)).astype(np.int64)
    dct = _dct_matrix()
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    coefs = []
    for plane, (h, v) in zip(planes, factors):
        if interleaved and n > 1:  # whole MCUs
            bw, bh = mcux * h, mcuy * v
        else:  # a one-component scan covers the component's own blocks
            bw, bh = -(-plane.shape[1] // 8), -(-plane.shape[0] // 8)
        b = _blocks(plane.astype(np.float64) - 128, bw, bh)
        f = np.einsum("ux,abxy,vy->abuv", dct, b, dct).reshape(bh, bw, 64)
        zz = np.round(f[..., _ZIGZAG] / q[_ZIGZAG]).astype(np.int64)
        coefs.append(zz)
    dc_bits = [0, 0, 0, 12] + [0] * 12  # 12 codes of 4 bits
    ac_syms = [0x00, 0xF0] + [(r << 4) | s for r in range(16)
                              for s in range(1, 11)]
    ac_bits = [0] * 7 + [len(ac_syms)] + [0] * 8  # 162 codes of 8 bits
    dc_code = {s: s for s in range(12)}
    ac_code = {s: i for i, s in enumerate(ac_syms)}

    def put_block(bits, zz, pred):
        diff = int(zz[0]) - pred
        cat = abs(diff).bit_length()
        bits.put(dc_code[cat], 4)
        if cat:
            bits.put(diff if diff >= 0 else diff + (1 << cat) - 1, cat)
        run = 0
        last = max([k for k in range(1, 64) if zz[k]] or [0])
        for k in range(1, last + 1):
            a = int(zz[k])
            if a == 0:
                run += 1
                continue
            while run > 15:
                bits.put(ac_code[0xF0], 8)
                run -= 16
            cat = abs(a).bit_length()
            bits.put(ac_code[(run << 4) | cat], 8)
            bits.put(a if a >= 0 else a + (1 << cat) - 1, cat)
            run = 0
        if last < 63:
            bits.put(ac_code[0x00], 8)
        return int(zz[0])

    out = b"\xff\xd8"
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0,
                                                      adobe))
    out += _segment(0xDB, bytes([0]) + bytes(int(x) for x in q[_ZIGZAG]))
    out += _segment(0xC0, struct.pack(">BHHB", 8, height, width, n) + b"".join(
        bytes([ids[i], (factors[i][0] << 4) | factors[i][1], 0])
        for i in range(n)))
    out += _segment(0xC4, bytes([0x00] + dc_bits + list(range(12))))
    out += _segment(0xC4, bytes([0x10] + ac_bits + ac_syms))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    scans = [list(range(n))] if interleaved else [[i] for i in range(n)]
    for comps in scans:
        out += _segment(0xDA, bytes([len(comps)]) + b"".join(
            bytes([ids[i], 0x00]) for i in comps) + bytes([0, 63, 0]))
        units = []  # (component, block row, block column) in scan order
        if len(comps) > 1:
            for my in range(mcuy):
                for mx in range(mcux):
                    units.append([(i, my * factors[i][1] + by,
                                   mx * factors[i][0] + bx)
                                  for i in comps
                                  for by in range(factors[i][1])
                                  for bx in range(factors[i][0])])
        else:
            i = comps[0]
            bh, bw = coefs[i].shape[:2]
            units = [[(i, r, c)] for r in range(bh) for c in range(bw)]
        bits, pred, rst = _Bits(), {i: 0 for i in comps}, 0
        for u, unit in enumerate(units):
            if restart and u and u % restart == 0:
                out += bits.flush() + bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) & 7
                pred = {i: 0 for i in comps}
            for i, r, c in unit:
                pred[i] = put_block(bits, coefs[i][r, c], pred[i])
        out += bits.flush()
    return out + b"\xff\xd9"


def _sampled(img: np.ndarray, factors) -> list:
    """Each channel of ``img`` box-averaged to its component's size."""
    h, w = img.shape[:2]
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    planes = []
    for k, (fh, fv) in enumerate(factors):
        sx, sy = hmax // fh, vmax // fv
        dw, dh = -(-w * fh // hmax), -(-h * fv // vmax)
        p = np.pad(img[..., k].astype(np.float64),
                   ((0, dh * sy - h), (0, dw * sx - w)), mode="edge")
        planes.append(p.reshape(dh, sy, dw, sx).mean((1, 3)).round()
                      .astype(np.uint8))
    return planes


def _pillow(img: np.ndarray, mode: str, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img, mode).save(b, "JPEG", **kw)
    return b.getvalue()


def fixtures() -> dict:
    """name -> the file's bytes."""
    out = {}
    (w0, h0), (w1, h1) = ENTRY_SIZES
    out["entry_baseline_420_rst.jpg"] = _pillow(
        smooth(w0, h0, 3, 1), "RGB", quality=90, subsampling=2,
        restart_marker_rows=2)
    out["entry_progressive_420.jpg"] = _pillow(
        smooth(w0, h0, 3, 2), "RGB", quality=90, subsampling=2,
        progressive=True)
    out["entry_baseline_444.jpg"] = _pillow(
        smooth(w1, h1, 3, 3), "RGB", quality=90, subsampling=0)
    out["entry_gray.jpg"] = _pillow(smooth(w1, h1, 1, 4)[..., 0], "L",
                                    quality=90)
    rng = np.random.default_rng(5)

    def noisy(w, h, c):
        return np.clip(smooth(w, h, c, int(rng.integers(1 << 30))).astype(int)
                       + rng.integers(-40, 41, (h, w, c)), 0, 255
                       ).astype(np.uint8)
    out["m_422_q50.jpg"] = _pillow(noisy(33, 17, 3), "RGB", quality=50,
                                   subsampling=1)
    out["m_progressive_rst_opt.jpg"] = _pillow(
        noisy(45, 29, 3), "RGB", quality=95, subsampling=2, progressive=True,
        restart_marker_blocks=2, optimize=True)
    out["m_cmyk_progressive.jpg"] = _pillow(noisy(21, 14, 4), "CMYK",
                                            quality=85, progressive=True)
    out["m_1x1_420.jpg"] = _pillow(noisy(1, 1, 3), "RGB", quality=75,
                                   subsampling=2)
    encoded = {  # name: (size, sampling factors, encoder options)
        "m_440_h1v2.jpg": ((33, 65), [(1, 2), (1, 1), (1, 1)], {}),
        "m_411_h4v1.jpg": ((37, 19), [(4, 1), (1, 1), (1, 1)], {}),
        "m_h3v1.jpg": ((29, 11), [(3, 1), (1, 1), (1, 1)], {}),
        "m_mixed_factors.jpg": ((29, 23), [(2, 2), (1, 2), (2, 1)], {}),
        "m_noninterleaved_rst.jpg": ((40, 24), [(2, 2), (1, 1), (1, 1)],
                                     dict(interleaved=False, restart=2)),
        "m_adobe_rgb.jpg": ((19, 13), [(1, 1)] * 3,
                            dict(jfif=False, adobe=0, ids=[82, 71, 66])),
        "m_adobe_ycck.jpg": ((21, 11), [(1, 1)] * 4,
                             dict(jfif=False, adobe=2)),
        "m_gray_2x2.jpg": ((17, 9), [(2, 2)], {}),
    }
    for name, ((w, h), factors, kw) in encoded.items():
        img = noisy(w, h, len(factors))
        out[name] = encode_baseline(_sampled(img, factors), factors,
                                    width=w, height=h, **kw)
    return out


# ------------------------------------------------------------------ WebP
class _Config(ctypes.Structure):
    """libwebp's ``WebPConfig`` (encode.h), room to spare at the end."""
    _fields_ = [(n, ctypes.c_float if n in ("quality", "target_PSNR")
                 else ctypes.c_int) for n in (
        "lossless quality method image_hint target_size target_PSNR "
        "segments sns_strength filter_strength filter_sharpness "
        "filter_type autofilter alpha_compression alpha_filtering "
        "alpha_quality pass_ show_compressed preprocessing partitions "
        "partition_limit emulate_jpeg_size thread_level low_memory "
        "near_lossless exact use_delta_palette use_sharp_yuv qmin "
        "qmax").split()] + [("pad", ctypes.c_uint32 * 16)]


_P, _I = ctypes.c_void_p, ctypes.c_int


class _Picture(ctypes.Structure):
    """libwebp's ``WebPPicture`` (encode.h)."""
    _fields_ = [("use_argb", _I), ("colorspace", _I), ("width", _I),
                ("height", _I), ("y", _P), ("u", _P), ("v", _P),
                ("y_stride", _I), ("uv_stride", _I), ("a", _P),
                ("a_stride", _I), ("pad1", ctypes.c_uint32 * 2),
                ("argb", _P), ("argb_stride", _I),
                ("pad2", ctypes.c_uint32 * 3), ("writer", _P),
                ("custom_ptr", _P), ("extra_info_type", _I),
                ("extra_info", _P), ("stats", _P), ("error_code", _I),
                ("progress_hook", _P), ("user_data", _P),
                ("pad3", ctypes.c_uint32 * 3), ("pad4", _P), ("pad5", _P),
                ("pad6", ctypes.c_uint32 * 8), ("memory_", _P),
                ("memory_argb_", _P), ("pad7", _P * 2)]


class _Writer(ctypes.Structure):
    _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)),
                ("size", ctypes.c_size_t), ("max_size", ctypes.c_size_t),
                ("pad", ctypes.c_uint32)]


_ABI = 0x020F  # WEBP_ENCODER_ABI_VERSION's major byte is what is checked


def _libwebp() -> ctypes.CDLL:
    """The libwebp Pillow bundles (its ``_webp`` module loads it first,
    with the libsharpyuv it needs)."""
    from PIL import _webp  # noqa: F401
    libs = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
    return ctypes.CDLL(str(sorted(libs.glob("libwebp-*.so*"))[0]))


def encode_webp(rgba: np.ndarray, **options) -> bytes:
    """A WebP file of the HxWx4 uint8 ``rgba`` written by libwebp's
    ``WebPEncode`` with ``WebPConfig`` fields ``options`` set (quality a
    float; the rest ints)."""
    lib = _libwebp()
    cfg = _Config()
    assert lib.WebPConfigInitInternal(ctypes.byref(cfg), 0,
                                      ctypes.c_float(75.0), _ABI)
    for k, v in options.items():
        setattr(cfg, k, v)
    assert lib.WebPValidateConfig(ctypes.byref(cfg)), options
    pic = _Picture()
    assert lib.WebPPictureInitInternal(ctypes.byref(pic), _ABI)
    a = np.ascontiguousarray(rgba, np.uint8)
    pic.use_argb, pic.width, pic.height = 1, a.shape[1], a.shape[0]
    assert lib.WebPPictureImportRGBA(ctypes.byref(pic),
                                     a.ctypes.data_as(_P), 4 * a.shape[1])
    wr = _Writer()
    lib.WebPMemoryWriterInit(ctypes.byref(wr))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, _P).value
    pic.custom_ptr = ctypes.addressof(wr)
    try:
        assert lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic)), \
            pic.error_code
        return ctypes.string_at(wr.mem, wr.size)
    finally:
        lib.WebPMemoryWriterClear(ctypes.byref(wr))
        lib.WebPPictureFree(ctypes.byref(pic))


def _pillow_webp(img: np.ndarray, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img, "RGBA" if img.shape[-1] == 4 else "RGB").save(
        b, "WEBP", **kw)
    return b.getvalue()


def _chunk(tag: bytes, data: bytes) -> bytes:
    return tag + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)


def _chunks(blob: bytes) -> dict:
    """tag -> payload of each chunk of a RIFF WEBP file (the last of a
    tag)."""
    out, pos = {}, 12
    while pos < len(blob):
        tag = blob[pos:pos + 4]
        (n,) = struct.unpack("<I", blob[pos + 4:pos + 8])
        out[tag] = blob[pos + 8:pos + 8 + n]
        pos += 8 + n + (n & 1)
    return out


def _riff(body: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def _vp8x(flags: int, w: int, h: int) -> bytes:
    return _chunk(b"VP8X", bytes([flags, 0, 0, 0])
                  + (w - 1).to_bytes(3, "little")
                  + (h - 1).to_bytes(3, "little"))


def _filter_alpha(a: np.ndarray, f: int) -> np.ndarray:
    """The alpha plane ``a`` with ALPH filter ``f`` (0 none, 1
    horizontal, 2 vertical, 3 gradient) applied, as libwebp's filters
    apply it: the first row predicted from the left, the first column
    from above."""
    x = a.astype(np.int32)
    pred = np.zeros_like(x)
    if f:
        pred[0, 1:] = x[0, :-1]
        pred[1:, 0] = x[:-1, 0]
        if f == 1:
            pred[1:, 1:] = x[1:, :-1]
        elif f == 2:
            pred[1:, 1:] = x[:-1, 1:]
        else:
            pred[1:, 1:] = np.clip(x[1:, :-1] + x[:-1, 1:] - x[:-1, :-1], 0,
                                   255)
    return ((x - pred) & 0xFF).astype(np.uint8)


def _alph(a: np.ndarray, method: int, f: int) -> bytes:
    """An ALPH payload of the alpha plane ``a``: raw (method 0) or the
    headerless VP8L stream of an image whose green is the filtered
    plane (method 1)."""
    d = _filter_alpha(a, f)
    if method == 0:
        return bytes([f << 2]) + d.tobytes()
    img = np.zeros(d.shape + (4,), np.uint8)
    img[..., 1], img[..., 3] = d, 255
    vp8l = _chunks(encode_webp(img, lossless=1, quality=ctypes.c_float(100),
                               method=4, exact=1))[b"VP8L"]
    return bytes([1 | (f << 2)]) + vp8l[5:]


def _with_alph(vp8: bytes, a: np.ndarray, method: int, f: int) -> bytes:
    """A VP8X file of the lossy bitstream ``vp8`` with an ALPH chunk."""
    h, w = a.shape
    return _riff(_vp8x(0x10, w, h) + _chunk(b"ALPH", _alph(a, method, f))
                 + _chunk(b"VP8 ", vp8))


def _anmf(x: int, y: int, w: int, h: int, frame: bytes) -> bytes:
    return _chunk(b"ANMF", b"".join(v.to_bytes(3, "little") for v in (
        x // 2, y // 2, w - 1, h - 1, 100)) + b"\0" + frame)


def _colors(w: int, h: int, n: int, seed: int) -> np.ndarray:
    """An HxW RGB image of ``n`` seeded colors, each pixel's drawn at
    random (every color used)."""
    rng = np.random.default_rng(seed)
    pal = rng.permutation(256 ** 3)[:n]
    pal = np.stack([pal >> 16, (pal >> 8) & 255, pal & 255], -1)
    idx = rng.integers(0, n, (h, w))
    idx.reshape(-1)[:n] = np.arange(n)
    return pal[idx].astype(np.uint8)


def webp_fixtures() -> dict:
    """name -> the WebP file's bytes."""
    out = {}
    (w0, h0), (w1, h1) = ENTRY_SIZES
    out[WEBP_ENTRY[0]] = _pillow_webp(smooth(w0, h0, 4, 11), quality=80)
    out[WEBP_ENTRY[1]] = _pillow_webp((smooth(w1, h1, 3, 12) // 8) * 8,
                                      lossless=True, quality=75, method=4)
    rng = np.random.default_rng(13)

    def photo(w, h, c=3):
        return np.clip(smooth(w, h, c, int(rng.integers(1 << 30))).astype(int)
                       + rng.integers(-24, 25, (h, w, c)), 0, 255
                       ).astype(np.uint8)
    f32 = ctypes.c_float
    # lossy through Pillow: qualities, methods, alpha, odd and even sizes
    for (w, h), q, m in [((1, 1), 75, 4), ((37, 21), 30, 0), ((64, 48), 75, 4),
                         ((33, 65), 95, 6), ((130, 97), 60, 2)]:
        out[f"w_lossy_{w}x{h}_q{q}_m{m}.webp"] = _pillow_webp(
            photo(w, h), quality=q, method=m)
    for (w, h), q in [((45, 29), 80), ((16, 16), 50)]:
        out[f"w_lossy_alpha_{w}x{h}_q{q}.webp"] = _pillow_webp(
            photo(w, h, 4), quality=q)
    out["w_lossy_meta_vp8x.webp"] = _pillow_webp(
        photo(27, 18), quality=70, icc_profile=b"\0" * 132,
        exif=b"Exif\0\0II*\0\x08\0\0\0\0\0", xmp=b"<x:xmpmeta/>")
    # what only libwebp's encoder sets
    enc = dict(quality=f32(70))
    base = np.dstack([photo(100, 70), np.full((70, 100), 255, np.uint8)])
    out["w_vp8_simple_filter.webp"] = encode_webp(
        base, filter_type=0, filter_strength=60, **enc)
    for k in range(1, 8):
        out[f"w_vp8_sharpness{k}.webp"] = encode_webp(
            base[:35, :51], filter_type=1, filter_strength=60,
            filter_sharpness=k, **enc)
    tall = np.dstack([photo(41, 150), np.full((150, 41), 255, np.uint8)])
    for p in (1, 2, 3):  # method 0: the methods above write one partition
        out[f"w_vp8_partitions{1 << p}.webp"] = encode_webp(
            tall, partitions=p, method=0, **enc)
    out["w_vp8_one_segment.webp"] = encode_webp(base, segments=1, **enc)
    flat = np.full((64, 80, 4), 255, np.uint8)  # macroblocks without
    flat[..., :3] = 90  # coefficients: skip flags (methods 0-2 write them)
    flat[16:40, 24:56, :3] = (200, 40, 120)
    out["w_vp8_skip_flags.webp"] = encode_webp(flat, method=1, **enc)
    out["w_vp8_filter_off.webp"] = encode_webp(
        base, filter_strength=0, autofilter=0, **enc)
    # ALPH chunks of each method and filter, on a lossy bitstream
    rgb = photo(39, 23)
    vp8 = _chunks(_pillow_webp(rgb, quality=70))[b"VP8 "]
    y, x = np.mgrid[0:23, 0:39]
    alpha = np.clip(x * 6 + y * 3 + rng.integers(-9, 10, (23, 39)), 0, 255
                    ).astype(np.uint8)
    for method, mname in ((0, "raw"), (1, "lossless")):
        for f, fname in enumerate(("none", "horizontal", "vertical",
                                   "gradient")):
            out[f"w_alph_{mname}_{fname}.webp"] = _with_alph(vp8, alpha,
                                                            method, f)
    # lossless: palettes of 2, 4, 16 and 256 colors, photo-like content
    for n, (w, h) in ((2, (31, 17)), (4, (40, 25)), (16, (23, 19)),
                      (256, (64, 64))):
        out[f"w_lossless_{n}colors.webp"] = _pillow_webp(
            _colors(w, h, n, n), lossless=True, quality=75, method=4)
    for (w, h), q, m in [((1, 1), 75, 4), ((57, 43), 100, 6),
                         ((96, 80), 50, 3), ((120, 66), 75, 0)]:
        out[f"w_lossless_{w}x{h}_q{q}_m{m}.webp"] = _pillow_webp(
            photo(w, h), lossless=True, quality=q, method=m)
    ra = photo(35, 27, 4)
    ra[::3, ::2, 3] = 0  # transparent pixels whose color ``exact`` keeps
    out["w_lossless_alpha_exact.webp"] = _pillow_webp(
        ra, lossless=True, exact=True, quality=90)
    # green between red and blue: subtract-green, predictor, cross-color
    g = photo(48, 36)
    g[..., 1] = g[..., 0] // 2 + g[..., 2] // 2
    out["w_lossless_three_transforms.webp"] = _pillow_webp(
        g, lossless=True, quality=50, method=2)
    # an animation: a small first frame (lossy + ALPH) offset on its canvas
    cw, ch = 40, 30
    f1 = photo(21, 13, 4)
    c1 = _chunks(encode_webp(f1, quality=f32(80), alpha_filtering=2))
    f2 = _chunks(_pillow_webp(photo(cw, ch), lossless=True))[b"VP8L"]
    out["w_animated_offset.webp"] = _riff(
        _vp8x(0x12, cw, ch) + _chunk(b"ANIM", b"\xff\xff\xff\xff\0\0")
        + _anmf(6, 4, 21, 13, _chunk(b"ALPH", c1[b"ALPH"])
                + _chunk(b"VP8 ", c1[b"VP8 "]))
        + _anmf(0, 0, cw, ch, _chunk(b"VP8L", f2)))
    return out


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    manifest = {"pillow": PIL.__version__,
                "libjpeg_turbo": features.version("libjpeg_turbo"),
                "libwebp": features.version("webp"),
                "files": {}}
    for name, blob in sorted({**fixtures(), **webp_fixtures()}.items()):
        (OUT / name).write_bytes(blob)
        im = Image.open(io.BytesIO(blob))
        manifest["files"][name] = {
            "size": list(im.size),
            "rgb_sha256": hashlib.sha256(np.asarray(im.convert("RGB"))
                                         .tobytes()).hexdigest(),
            "l_sha256": hashlib.sha256(np.asarray(im.convert("L"))
                                       .tobytes()).hexdigest(),
            "bytes": len(blob)}
    (OUT / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum(f["bytes"] for f in manifest["files"].values())
    print(f"{len(manifest['files'])} files, {total} bytes, in {OUT}")


if __name__ == "__main__":
    main()
