"""Write the JPEG and WebP fixtures of ``tests/fixtures/images/`` and their
manifest.

    python tools/make_image_fixtures.py   # Pillow, gcc, libjpeg (not the card)

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
* ``a_*.jpg``, ``l_*.jpg``, ``t_*.jpg``, ``d_*.jpg`` and the phase 11
  entries ``entry_arith_progressive_420.jpg`` (1024x1024) and
  ``entry_lossless.jpg`` (1216x832, posterized to steps of 8): what
  libjpeg-turbo reads beyond Huffman frames.  Arithmetic files are
  Pillow's re-coded by libjpeg-turbo's own encoder (``transcode``: a C
  transcoder built by gcc against the system's libjpeg), each decoding
  as its Huffman source; lossless ones come from ``encode_lossless``
  (predictors 1-7, point transform, restarts, 1 and 3 components,
  4:2:0, one scan a component), each equal to its source at Pt 0;
  ``t_*`` are progressive files cut after some scans (block
  smoothing); ``d_*`` damaged streams libjpeg decodes with a warning (a
  bad Huffman code, a wrong RST, stray bytes, a segment cut short).
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
  bitstreams.  ``w_vp8_segment_map_*.webp``: a VP8 key frame whose
  segment header updates the map without its data (quantizers and
  filter strengths), which libwebp's encoder never writes, made from
  one of its frames by ``vp8_map_only`` (the first partition decoded
  and re-coded with a boolean coder), once with the map's tree
  probabilities written and once with the 255 they default to.
* ``r_sof9_12bit.jpg``: a file Pillow's ``Image.open`` refuses
  (Pillow's 8x8 JPEG with its frame header made SOF9 of 12-bit
  samples), which phase 11 puts among its images for the bucketing to
  skip and name; listed under the manifest's ``refused`` with Pillow's
  exception, not under ``files``.
* ``manifest.json``: each file's size and the sha256 of Pillow's
  ``convert("RGB")`` and ``convert("L")`` bytes, with Pillow's,
  libjpeg-turbo's and libwebp's versions; for an arithmetic or lossless
  file, the sha256 of its source's RGB too (``source_rgb_sha256``).
  ``tests/test_torch_image_decode.py`` (JPEG) and
  ``tests/test_torch_webp.py`` hold it equal to Pillow's decode of the
  committed bytes and to the port's; ``chip_smoke.py`` holds the port's
  decode on the card's host to it.
"""
import atexit
import ctypes
import functools
import hashlib
import io
import json
import math
import struct
import subprocess
import tempfile
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


def huffman_bits(freq: dict) -> tuple:
    """(bits[1..16], symbols) of the optimal JPEG Huffman table for the
    symbol counts ``freq`` (Annex K.2 and K.3, as libjpeg's
    ``jpeg_gen_optimal_table`` builds it: a reserved symbol keeps any code
    from being all ones, lengths are cut to 16 bits)."""
    f = {s: c for s, c in freq.items() if c}
    f[256] = 1
    size = {s: 0 for s in f}
    other = {s: None for s in f}
    while True:
        live = sorted((c, -s) for s, c in f.items() if c)
        if len(live) < 2:
            break
        c1, c2 = -live[0][1], -live[1][1]
        f[c1] += f[c2]
        f[c2] = 0
        s = c1
        size[s] += 1
        while other[s] is not None:
            s = other[s]
            size[s] += 1
        other[s] = c2
        s = c2
        size[s] += 1
        while other[s] is not None:
            s = other[s]
            size[s] += 1
    bits = [0] * 33
    for s, n in size.items():
        bits[n] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # the reserved symbol's code
    syms = sorted((n, s) for s, n in size.items() if s != 256)
    return bits[1:17], [s for _, s in syms]


def _codes(bits, syms) -> dict:
    """symbol -> (code, length) of the canonical table ``bits``."""
    out, code, k = {}, 0, 0
    for n in range(1, 17):
        for _ in range(bits[n - 1]):
            out[syms[k]] = (code, n)
            code += 1
            k += 1
        code <<= 1
    return out


def _predict(x: np.ndarray, predictor: int, pt: int, first) -> np.ndarray:
    """The lossless predictions of the samples ``x`` (already shifted by
    the point transform): the first row of the scan and of each restart
    interval (the rows in ``first``) from the left neighbour (the first
    sample from 1 << (7 - pt)), other rows' first samples from above."""
    ra = np.zeros_like(x)
    ra[:, 1:] = x[:, :-1]
    rb = np.zeros_like(x)
    rb[1:] = x[:-1]
    rc = np.zeros_like(x)
    rc[1:, 1:] = x[:-1, :-1]
    pred = (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
            rb + ((ra - rc) >> 1), (ra + rb) >> 1)[predictor - 1].copy()
    pred[:, 0] = rb[:, 0]
    for y in first:
        pred[y] = ra[y]
        pred[y, 0] = 1 << (7 - pt)
    return pred


def _category(d: np.ndarray) -> np.ndarray:
    """The difference categories (SSSS) of ``d``: its bit length, and 16
    for -32768 (32768 mod 2^16)."""
    cat = np.ceil(np.log2(np.abs(d) + 1)).astype(np.int64)
    return np.where(d == -32768, 16, cat)


def _bitstream(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """The fields ``values`` of ``lengths`` bits, MSB first, the last
    byte padded with 1-bits, 0xFF bytes stuffed."""
    n = int(lengths.sum())
    ends = np.cumsum(lengths)
    owner = np.repeat(np.arange(len(lengths)), lengths)
    shift = ends[owner] - 1 - np.arange(n)
    bits = (values[owner] >> shift) & 1
    bits = np.concatenate([bits, np.ones(-n % 8, np.int64)])
    out = np.packbits(bits.astype(np.uint8)).tobytes()
    return out.replace(b"\xff", b"\xff\x00")


def encode_lossless(planes, factors, predictor=1, pt=0, restart_rows=0,
                    interleaved=True, jfif=False, width=None,
                    height=None) -> bytes:
    """A lossless JPEG (SOF3) of ``planes`` (each component's 8-bit
    samples at its sampled size) with sampling ``factors``: selection
    value ``predictor`` (1-7), point transform ``pt``, a restart marker
    every ``restart_rows`` MCU rows, one interleaved scan or one scan a
    component, no JFIF marker unless ``jfif`` (libjpeg then takes three
    components for RGB), component ids 1..n.  One optimal Huffman table
    codes every difference category."""
    n = len(planes)
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mcux, mcuy = -(-width // hmax), -(-height // vmax)
    scans = [list(range(n))] if interleaved and n > 1 else [
        [i] for i in range(n)]
    coded = []  # per scan: its components, the differences in scan
    for comps in scans:  # order, and the MCUs of a restart interval
        single = len(comps) == 1
        cols = []
        for i in comps:
            x = planes[i].astype(np.int64) >> pt
            ch, cw = x.shape
            fh, fv = (1, 1) if single else factors[i]
            rows = ch if single else mcuy * fv
            step = restart_rows * fv if restart_rows else rows
            d = (x - _predict(x, predictor, pt, range(0, ch, step))) & 0xFFFF
            d = np.where(d >= 32768, d - 65536, d)
            full = np.zeros((rows, cw if single else mcux * fh), np.int64)
            full[:ch, :cw] = d  # the MCUs' dummy samples code 0
            # [MCU row, MCU column, the component's samples in the MCU]
            cols.append(full.reshape(rows // fv, fv, -1, fh)
                        .transpose(0, 2, 1, 3).reshape(rows // fv, -1,
                                                       fv * fh))
        diffs = np.concatenate(cols, -1)
        per_row = diffs.shape[1]
        coded.append((comps, diffs.reshape(-1), restart_rows * per_row,
                      diffs.shape[2]))
    bits, syms = huffman_bits(dict(zip(*np.unique(
        _category(np.concatenate([c[1] for c in coded])),
        return_counts=True))))
    code = _codes(bits, syms)
    table = np.zeros((17, 2), np.int64)
    for k, (c, l) in code.items():
        table[k] = c, l
    out = b"\xff\xd8"
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += _segment(0xC3, struct.pack(">BHHB", 8, height, width, n) + b"".join(
        bytes([i + 1, (factors[i][0] << 4) | factors[i][1], 0])
        for i in range(n)))
    out += _segment(0xC4, bytes([0x00] + bits + [int(x) for x in syms]))
    for comps, d, interval, per_mcu in coded:
        if interval:
            out += _segment(0xDD, struct.pack(">H", interval))
        out += _segment(0xDA, bytes([len(comps)]) + b"".join(
            bytes([i + 1, 0x00]) for i in comps) + bytes([predictor, 0, pt]))
        cat = _category(d)
        extra = np.where(d >= 0, d, d + (1 << cat) - 1)
        extra_len = np.where(cat == 16, 0, cat)
        vals = np.stack([table[cat, 0], extra], 1).reshape(-1)
        lens = np.stack([table[cat, 1], extra_len], 1).reshape(-1)
        seg = (interval or len(d) // per_mcu) * per_mcu * 2
        for k, start in enumerate(range(0, len(vals), seg)):
            if k:
                out += bytes([0xFF, 0xD0 + (k - 1) % 8])
            out += _bitstream(vals[start:start + seg], lens[start:start + seg])
    return out + b"\xff\xd9"


# a JPEG transcoder (coefficients kept, re-coded arithmetic), built
# against the system's libjpeg: libjpeg-turbo's own encoder is the one
# that writes arithmetic-coded files
_TRANSCODER = r"""
#include <stdio.h>
#include <stdlib.h>
#include <jpeglib.h>
int main(int argc, char** argv) {  /* prog restart_rows L U K */
  struct jpeg_decompress_struct d; struct jpeg_compress_struct c;
  struct jpeg_error_mgr e1, e2;
  d.err = jpeg_std_error(&e1); jpeg_create_decompress(&d);
  jpeg_stdio_src(&d, stdin); jpeg_read_header(&d, TRUE);
  jvirt_barray_ptr* coef = jpeg_read_coefficients(&d);
  c.err = jpeg_std_error(&e2); jpeg_create_compress(&c);
  jpeg_stdio_dest(&c, stdout);
  jpeg_copy_critical_parameters(&d, &c);
  c.arith_code = TRUE;
  if (atoi(argv[1])) jpeg_simple_progression(&c);
  c.restart_in_rows = atoi(argv[2]);
  for (int i = 0; i < NUM_ARITH_TBLS; i++) {
    c.arith_dc_L[i] = atoi(argv[3]); c.arith_dc_U[i] = atoi(argv[4]);
    c.arith_ac_K[i] = atoi(argv[5]);
  }
  jpeg_write_coefficients(&c, coef);
  jpeg_finish_compress(&c); jpeg_finish_decompress(&d);
  return 0;
}
"""


@functools.lru_cache(maxsize=None)
def _transcoder() -> str:
    d = tempfile.TemporaryDirectory(prefix="jpeg_transcoder_")
    atexit.register(d.cleanup)
    src, exe = Path(d.name) / "transcode.c", Path(d.name) / "transcode"
    src.write_text(_TRANSCODER)
    subprocess.run(["gcc", "-O2", str(src), "-o", str(exe), "-ljpeg"],
                   check=True, capture_output=True)
    return str(exe)


def transcode(blob: bytes, progressive: bool = False, restart_rows: int = 0,
              dac=(0, 1, 5)) -> bytes:
    """The JPEG ``blob`` with its coefficients re-coded arithmetic (SOF9,
    or SOF10 with libjpeg's standard progression), a restart marker every
    ``restart_rows`` MCU rows, the DAC conditioning ``dac`` (L, U, K) for
    every table."""
    return subprocess.run(
        [_transcoder(), str(int(progressive)),
         str(restart_rows), *map(str, dac)],
        input=blob, check=True, capture_output=True).stdout


def without_segments(blob: bytes, marker: int) -> bytes:
    """``blob`` with every segment of ``marker`` before the first scan's
    data and between scans removed (a DAC, say)."""
    out, i = bytearray(blob[:2]), 2
    while i < len(blob):
        if blob[i] == 0xFF and blob[i + 1] not in (0, 0xFF, *range(0xD0,
                                                                  0xDA)):
            n = struct.unpack(">H", blob[i + 2:i + 4])[0]
            if blob[i + 1] != marker:
                out += blob[i:i + 2 + n]
            i += 2 + n
            if blob[i - 2 - n + 1] == 0xDA:  # copy the scan's data
                j = i
                while not (blob[j] == 0xFF and blob[j + 1] not in (
                        0, *range(0xD0, 0xD8))):
                    j += 1
                out += blob[i:j]
                i = j
        else:
            out.append(blob[i])
            i += 1
    return bytes(out)


def scan_starts(blob: bytes) -> list:
    """The offsets of the SOS markers of ``blob``."""
    out, i = [], blob.index(b"\xff\xda")
    while i >= 0:
        out.append(i)
        i = blob.find(b"\xff\xda", i + 2)
    return out


def cut_after_scans(blob: bytes, k: int) -> bytes:
    """A progressive ``blob`` whose scans after the first ``k`` are cut
    off, EOI put back: the refinement a download cut short leaves out."""
    return blob[:scan_starts(blob)[k]] + b"\xff\xd9"


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
    out.update(libjpeg_fixtures())
    return out


def _digest(rgb: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()


def _rgb_of(blob: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))


# name -> the sha256 of what the file must decode to besides Pillow's
# decode of its own bytes: an arithmetic file's Huffman source as Pillow
# decodes it, a lossless file's source samples at Pt 0
SOURCES = {}


def libjpeg_fixtures() -> dict:
    """The JPEGs that libjpeg-turbo reads beyond baseline and progressive
    Huffman frames: arithmetic coding, lossless frames, progressive files
    cut short (block smoothing) and damaged streams it recovers from."""
    out = {}
    rng = np.random.default_rng(21)

    def noisy(w, h, c):
        return np.clip(smooth(w, h, c, int(rng.integers(1 << 30))).astype(int)
                       + rng.integers(-40, 41, (h, w, c)), 0, 255
                       ).astype(np.uint8)

    (w0, h0), (w1, h1) = ENTRY_SIZES
    # arithmetic coding: libjpeg-turbo's encoder re-codes Pillow's files
    # (coefficients kept, so each decodes as its Huffman source)
    arith = {  # name: (source, transcode options)
        "a_seq_420_rst.jpg": (_pillow(noisy(45, 29, 3), "RGB", quality=90,
                                      subsampling=2), dict(restart_rows=1)),
        "a_seq_444_dac.jpg": (_pillow(noisy(33, 17, 3), "RGB", quality=75,
                                      subsampling=0), dict(dac=(2, 6, 12))),
        "a_seq_gray.jpg": (_pillow(noisy(17, 9, 1)[..., 0], "L",
                                   quality=95), {}),
        "a_prog_420.jpg": (_pillow(noisy(45, 29, 3), "RGB", quality=90,
                                   subsampling=2), dict(progressive=True)),
        "a_prog_gray_rst.jpg": (_pillow(noisy(40, 24, 1)[..., 0], "L",
                                        quality=85),
                                dict(progressive=True, restart_rows=1)),
        "entry_arith_progressive_420.jpg": (out_entry := _pillow(
            smooth(w0, h0, 3, 2), "RGB", quality=90, subsampling=2,
            progressive=True), dict(progressive=True)),
    }
    del out_entry
    for name, (src, kw) in arith.items():
        out[name] = transcode(src, **kw)
        SOURCES[name] = _digest(_rgb_of(src))
    # a file whose DAC segments are left out: libjpeg's defaults
    out["a_prog_no_dac.jpg"] = without_segments(out["a_prog_420.jpg"], 0xCC)
    SOURCES["a_prog_no_dac.jpg"] = SOURCES["a_prog_420.jpg"]
    # lossless frames (SOF3), one each predictor
    lossless = {  # name: (size, sampling factors, encoder options)
        **{f"l_p{p}.jpg": ((23, 17), [(1, 1)] * 3, dict(predictor=p))
           for p in range(1, 8)},
        "l_gray_pt2_rst.jpg": ((33, 65), [(1, 1)], dict(
            predictor=4, pt=2, restart_rows=3)),
        "l_420_rst.jpg": ((29, 23), [(2, 2), (1, 1), (1, 1)], dict(
            predictor=7, restart_rows=2)),
        "l_noninterleaved.jpg": ((20, 12), [(1, 1)] * 3, dict(
            predictor=6, interleaved=False)),
    }
    for name, ((w, h), factors, kw) in lossless.items():
        img = noisy(w, h, len(factors))
        planes = _sampled(img, factors)
        out[name] = encode_lossless(planes, factors, width=w, height=h, **kw)
        if kw.get("pt", 0) == 0:  # the samples, each plane box-upsampled
            hmax = max(f[0] for f in factors)
            vmax = max(f[1] for f in factors)
            full = np.stack([p.repeat(vmax // fv, 0).repeat(hmax // fh, 1)[
                :h, :w] for p, (fh, fv) in zip(planes, factors)], -1)
            SOURCES[name] = _digest(full if full.shape[2] == 3 else
                                    np.repeat(full, 3, 2))
    post = smooth(w1, h1, 3, 6) // 8 * 8  # posterized: it stays small
    out["entry_lossless.jpg"] = encode_lossless(
        [post[..., k] for k in range(3)], [(1, 1)] * 3, width=w1, height=h1)
    SOURCES["entry_lossless.jpg"] = _digest(post)
    # progressive files cut short after some scans (EOI put back): libjpeg
    # smooths the blocks whose low coefficients stay unrefined
    prog = _pillow(noisy(45, 29, 3), "RGB", quality=90, subsampling=2,
                   progressive=True)
    out["t_prog_dc_only.jpg"] = cut_after_scans(prog, 1)
    out["t_prog_420_3scans.jpg"] = cut_after_scans(prog, 3)
    out["t_prog_gray_2wide.jpg"] = cut_after_scans(_pillow(
        noisy(16, 40, 1)[..., 0], "L", quality=80, progressive=True), 2)
    out["t_arith_prog_cut.jpg"] = cut_after_scans(
        transcode(prog, progressive=True), 4)
    # damaged streams that libjpeg decodes with a warning
    base = _pillow(noisy(48, 32, 3), "RGB", quality=90, subsampling=2)
    rst = _pillow(noisy(96, 64, 3), "RGB", quality=90, subsampling=2,
                  restart_marker_blocks=2)
    sos = base.index(b"\xff\xda")
    mid = (sos + len(base)) // 2
    # 32 one-bits: codes no Huffman table has
    out["d_bad_huffman.jpg"] = base[:mid] + b"\xff\x00" * 4 + base[
        mid + 8:]
    marks = [i for i in range(rst.index(b"\xff\xda"), len(rst) - 1)
             if rst[i] == 0xFF and 0xD0 <= rst[i + 1] <= 0xD7]
    k = marks[len(marks) // 2]
    out["d_wrong_rst.jpg"] = rst[:k + 1] + bytes(
        [0xD0 + (rst[k + 1] - 0xD0 + 3) % 8]) + rst[k + 2:]
    out["d_extraneous.jpg"] = rst[:k] + b"\x12\x34\x56" + rst[k:]
    out["d_segment_cut.jpg"] = rst[:marks[2] - 6] + rst[marks[2]:]
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


class _BoolDecoder:
    """RFC 6386's boolean decoder (section 7.3)."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 2
        self.value = int.from_bytes(data[:2], "big")
        self.range, self.count = 255, 0

    def get(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if self.value >= split << 8:
            bit, self.range, self.value = 1, self.range - split, (
                self.value - (split << 8))
        else:
            bit, self.range = 0, split
        while self.range < 128:
            self.value, self.range = self.value << 1, self.range << 1
            self.count += 1
            if self.count == 8:
                self.count = 0
                if self.pos < len(self.data):
                    self.value |= self.data[self.pos]
                self.pos += 1
        return bit


class _BoolEncoder:
    """RFC 6386's boolean encoder (section 7.3)."""

    def __init__(self):
        self.out, self.range, self.bottom, self.count = bytearray(), 255, 0, 24

    def _carry(self) -> None:
        k = len(self.out) - 1
        while self.out[k] == 255:
            self.out[k] = 0
            k -= 1
        self.out[k] += 1

    def put(self, bit: int, prob: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if not self.count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.count = 8

    def flush(self) -> bytes:
        c, v = self.count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range((c >> 3) - 1):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


@functools.lru_cache(None)
def _vp8_table(name: str, shape: tuple) -> np.ndarray:
    """A constant table of the port's VP8 decoder (RFC 6386's), read from
    its source: the fixtures hold that decoder to Pillow's, so a wrong
    entry shows there."""
    import re
    src = (Path(__file__).resolve().parents[1] / "sdxl_training_improvements"
           "_tpu_torch" / "native" / "webp_decode.cpp").read_text()
    body = src[src.index(f"{name}["):]
    body = body[body.index("{"):body.index("};")]
    return np.array([int(v) for v in re.findall(r"\d+", body)]
                    ).reshape(shape)


def vp8_map_only(frame: bytes, tree_probs: bool) -> bytes:
    """The VP8 key frame ``frame`` (a segment header that updates the map
    and the data, as libwebp writes one) with a segment header that
    updates the map alone: the segments' quantizers and filter strengths
    then keep their defaults (absolute values of 0: the finest
    quantizer, no loop filter).  The map's tree probabilities are
    written if ``tree_probs``, else left at their default 255, and each
    macroblock's segment id is coded with them.  The first partition is
    decoded and coded anew, bool for bool; the token partitions are
    kept as they are."""
    bits = frame[0] | frame[1] << 8 | frame[2] << 16
    if bits & 1:
        raise ValueError("not a key frame")
    size0 = bits >> 5
    w, h = (struct.unpack("<H", frame[6:8])[0] & 0x3FFF,
            struct.unpack("<H", frame[8:10])[0] & 0x3FFF)
    dec, enc = _BoolDecoder(frame[10:10 + size0]), _BoolEncoder()

    def copy(prob: int = 128) -> int:
        bit = dec.get(prob)
        enc.put(bit, prob)
        return bit

    def lit(n: int, keep: bool = True) -> int:
        v = 0
        for _ in range(n):
            bit = dec.get(128)
            if keep:
                enc.put(bit, 128)
            v = v << 1 | bit
        return v

    def signed(n: int, keep: bool = True) -> None:
        if lit(1, keep):
            lit(n + 1, keep)  # the value and its sign

    lit(2)  # color space, clamping
    if not (copy() and copy() and dec.get(128)):
        raise ValueError("not a segment header with a map and data")
    enc.put(0, 128)  # update_segment_feature_data = 0
    lit(1, False)  # absolute or delta
    for _ in range(4):
        signed(7, False)
    for _ in range(4):
        signed(6, False)
    seg = [255, 255, 255]
    for k in range(3):
        if dec.get(128):
            seg[k] = lit(8, False)
        if tree_probs:
            enc.put(1, 128)
            for b in range(7, -1, -1):
                enc.put(seg[k] >> b & 1, 128)
        else:
            enc.put(0, 128)
    old_seg = list(seg)
    if not tree_probs:
        seg = [255, 255, 255]
    lit(10)  # filter type, level, sharpness
    if copy():  # loop filter deltas
        if copy():
            for _ in range(8):
                signed(6)
    lit(2)  # token partitions
    lit(7)  # base quantizer
    for _ in range(5):
        signed(4)
    lit(1)  # refresh entropy probs
    update = _vp8_table("kCoeffsUpdateProba", (4, 8, 3, 11))
    for prob in update.reshape(-1):
        if copy(int(prob)):
            lit(8)
    skip_p = lit(8) if copy() else None
    bmodes = _vp8_table("kBModesProba", (10, 10, 9))
    mb_w, mb_h = (w + 15) >> 4, (h + 15) >> 4
    top = [0] * (4 * mb_w)
    for _ in range(mb_h):
        left = [0] * 4
        for mx in range(mb_w):
            if dec.get(old_seg[0]):
                enc.put(1, seg[0])
                sid = 2 + dec.get(old_seg[2])
                enc.put(sid - 2, seg[2])
            else:
                enc.put(0, seg[0])
                sid = dec.get(old_seg[1])
                enc.put(sid, seg[1])
            if skip_p is not None:
                copy(skip_p)
            t = top[4 * mx:4 * mx + 4]
            if copy(145):  # a 16x16 mode
                ymode = (1 if copy(128) else 3) if copy(156) else (
                    2 if copy(163) else 0)
                t, left = [ymode] * 4, [ymode] * 4
            else:
                for y in range(4):
                    mode = left[y]
                    for x in range(4):
                        p = bmodes[t[x]][mode]
                        if not copy(p[0]):
                            mode = 0
                        elif not copy(p[1]):
                            mode = 1
                        elif not copy(p[2]):
                            mode = 2
                        elif not copy(p[3]):
                            mode = 3 if not copy(p[4]) else (
                                5 if not copy(p[5]) else 6)
                        else:
                            mode = 4 if not copy(p[6]) else (
                                7 if not copy(p[7]) else (
                                    8 if not copy(p[8]) else 9))
                        t[x] = mode
                    left[y] = mode
            top[4 * mx:4 * mx + 4] = t
            if copy(142) and copy(114):  # chroma mode
                copy(183)
    part0 = enc.flush()
    head = (bits & 0x1F) | len(part0) << 5
    return (head.to_bytes(3, "little") + frame[3:10] + part0
            + frame[10 + size0:])


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
    # the segment map without its data (libwebp writes both or neither)
    seg = _chunks(encode_webp(base, **enc))[b"VP8 "]
    for probs, name in ((True, "tree_probs"), (False, "default_probs")):
        out[f"w_vp8_segment_map_{name}.webp"] = _riff(
            _chunk(b"VP8 ", vp8_map_only(seg, probs)))
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


def refused_fixtures() -> dict:
    """name -> the bytes of a file Pillow refuses."""
    b = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(b, "JPEG")
    return {"r_sof9_12bit.jpg": b.getvalue().replace(
        b"\xff\xc0\x00\x11\x08", b"\xff\xc9\x00\x11\x0c", 1)}


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
        if name in SOURCES:  # an arithmetic or lossless file's source
            manifest["files"][name]["source_rgb_sha256"] = SOURCES[name]
            assert SOURCES[name] == manifest["files"][name]["rgb_sha256"], \
                name
    manifest["refused"] = {}
    for name, blob in sorted(refused_fixtures().items()):
        (OUT / name).write_bytes(blob)
        try:
            Image.open(io.BytesIO(blob))
        except Exception as e:  # what Pillow raises is recorded
            manifest["refused"][name] = {"pillow": type(e).__name__,
                                         "bytes": len(blob)}
        else:
            raise AssertionError(f"Pillow reads {name}")
    (OUT / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum(f["bytes"] for f in manifest["files"].values())
    print(f"{len(manifest['files'])} files, {total} bytes, in {OUT}")


if __name__ == "__main__":
    main()
