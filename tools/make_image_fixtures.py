"""Write the JPEG fixtures of ``tests/fixtures/images/`` and their manifest.

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
* ``manifest.json``: each file's size and the sha256 of Pillow's
  ``convert("RGB")`` and ``convert("L")`` bytes, with Pillow's and
  libjpeg-turbo's versions.  ``tests/test_torch_image_decode.py`` holds
  it equal to Pillow's decode of the committed bytes and to the port's;
  ``chip_smoke.py`` holds the port's decode on the card's host to it.
"""
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


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    manifest = {"pillow": PIL.__version__,
                "libjpeg_turbo": features.version("libjpeg_turbo"),
                "files": {}}
    for name, blob in sorted(fixtures().items()):
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
