"""PyTorch port: the image reader (``images.py``) against Pillow and JAX.

* JPEG: the port's ``read_rgb`` / ``read_gray`` / ``read_image_size``
  equal Pillow's ``convert("RGB")`` / ``convert("L")`` / ``.size``
  (``np.array_equal``) on files Pillow writes from seeded numpy arrays:
  L, RGB and CMYK; subsampling 4:4:4, 4:2:2 and 4:2:0; baseline,
  ``optimize`` and ``progressive``; no restart markers,
  ``restart_marker_blocks`` and ``restart_marker_rows``; quality 50, 90
  and 100; sizes 1x1, 17x9, 33x65 and 256x160.  The committed fixtures
  (``tools/make_image_fixtures.py``: other sampling factors, one scan a
  component, Adobe RGB and YCCK) equal their manifest, which equals
  Pillow's decode of the same bytes.  Truncated and corrupt files that
  Pillow refuses are refused, naming the file.
* PNG: every color type at every bit depth, non-interlaced and Adam7
  (written here with numpy and zlib where Pillow cannot write them;
  palette files with a short PLTE and a tRNS chunk), and files Pillow
  writes ("1", "P" at 1-8 bits, "I;16"), equal Pillow's ``convert``.
* The precompute over a folder of JPEG, palette, 16-bit and Adam7 files
  writes a cache bit-equal to the JAX package's, buckets included; and
  ``generate.py``'s ``--init`` from a JPEG and ``--mask`` from a palette
  PNG equal JAX's ``_load_images`` / ``_load_masks``.
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
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from sdxl_training_improvements_tpu import generate as jax_generate
from sdxl_training_improvements_tpu import native as jax_native
from sdxl_training_improvements_tpu.config import Config as JConfig
from sdxl_training_improvements_tpu.data import cache as JCa
from sdxl_training_improvements_tpu.data import dataset as JD
from sdxl_training_improvements_tpu_torch import generate, images, native, png
from sdxl_training_improvements_tpu_torch.config import Config as TConfig
from sdxl_training_improvements_tpu_torch.data import cache as TCa
from sdxl_training_improvements_tpu_torch.data import dataset as TD

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"
JPEG_SIZES = [(1, 1), (17, 9), (33, 65), (256, 160)]
QUALITIES = [50, 90, 100]


def _pixels(w: int, h: int, channels: int, seed: int) -> np.ndarray:
    """Seeded gradients with noise: every coefficient band in use, yet
    under the 2 bytes a pixel that Pillow's encoder buffers at quality
    100 with ``optimize`` or ``progressive``."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * (k + 1) + y * (3 - k)) * 200 // (4 * (w + h))
                     + 20 * k for k in range(channels)], -1)
    a = np.clip(base + rng.integers(-10, 11, base.shape), 0, 255)
    return a.astype(np.uint8)


def _assert_reads_as_pillow(path) -> None:
    with Image.open(path) as im:
        size = im.size
        rgb = np.asarray(im.convert("RGB"))
        gray = np.asarray(im.convert("L"))
    assert images.read_image_size(path) == size
    got = images.read_rgb(path)
    assert got.dtype == np.uint8 and np.array_equal(got, rgb), path
    got = images.read_gray(path)
    assert got.dtype == np.uint8 and np.array_equal(got, gray), path


_JPEG_CASES = [(mode, sub, kind, rst)
               for mode, subs in (("RGB", (0, 1, 2)), ("L", (0,)),
                                  ("CMYK", (0,)))
               for sub in subs
               for kind in ("baseline", "optimize", "progressive")
               for rst in (None, "blocks", "rows")]


@pytest.mark.parametrize("mode,sub,kind,rst", _JPEG_CASES)
def test_jpeg_bit_exact_to_pillow(tmp_path, mode, sub, kind, rst):
    channels = {"L": 1, "RGB": 3, "CMYK": 4}[mode]
    for i, ((w, h), q) in enumerate((s, q) for s in JPEG_SIZES
                                    for q in QUALITIES):
        a = _pixels(w, h, channels, zlib.crc32(repr((mode, w, q)).encode()))
        kw = dict(quality=q, subsampling=sub)
        if kind != "baseline":
            kw[kind] = True
        if rst == "blocks":
            kw["restart_marker_blocks"] = 3
        elif rst == "rows":
            kw["restart_marker_rows"] = 1
        path = tmp_path / f"{i}.jpg"
        Image.fromarray(a[..., 0] if channels == 1 else a, mode).save(
            path, "JPEG", **kw)
        _assert_reads_as_pillow(path)


def _manifest() -> dict:
    return json.loads((FIXTURES / "manifest.json").read_text())


@pytest.mark.parametrize("name", sorted(
    n for n in _manifest()["files"] if n.endswith(".jpg")))
def test_jpeg_fixtures_match_manifest(name):
    """The manifest is Pillow's decode of the committed bytes, and the
    port's decode is the manifest."""
    entry = _manifest()["files"][name]
    path = FIXTURES / name

    def digests(rgb, gray):
        return (hashlib.sha256(np.ascontiguousarray(rgb).tobytes())
                .hexdigest(),
                hashlib.sha256(np.ascontiguousarray(gray).tobytes())
                .hexdigest())
    want = (entry["rgb_sha256"], entry["l_sha256"])
    with Image.open(path) as im:
        assert list(im.size) == entry["size"]
        assert digests(np.asarray(im.convert("RGB")),
                       np.asarray(im.convert("L"))) == want
    assert list(images.read_image_size(path)) == entry["size"]
    assert digests(images.read_rgb(path), images.read_gray(path)) == want


def _pillow_refuses(path) -> bool:
    try:
        with Image.open(path) as im:
            im.convert("RGB")
    except (OSError, SyntaxError, ValueError):
        return True
    return False


def _without_first_dht(blob: bytes) -> bytes:
    dht = blob.index(b"\xff\xc4")
    n = struct.unpack(">H", blob[dht + 2:dht + 4])[0]
    return blob[:dht] + blob[dht + 2 + n:]


def _corrupt_variants(blob: bytes, progressive: bool) -> dict:
    """name -> a damaged copy of the JPEG ``blob``."""
    sos = blob.index(b"\xff\xda")
    dht = blob.index(b"\xff\xc4")
    out = {
        "cut in the header": blob[:sos - 7],
        "cut after the frame header": blob[:sos],
        "cut in the scan": blob[:(sos + len(blob)) // 2],
        "cut before EOI": blob[:-2],
        "cut inside EOI": blob[:-1],
        # a table whose counts overflow their code lengths
        "bad Huffman table": blob[:dht + 5] + b"\x05" + blob[dht + 6:],
    }
    if progressive:  # a scan names a table no DHT defined
        out["no Huffman table"] = _without_first_dht(blob)
    return out


@pytest.mark.parametrize("progressive", [False, True])
def test_jpeg_truncated_and_corrupt_refused(tmp_path, progressive):
    src = tmp_path / "src.jpg"
    Image.fromarray(_pixels(40, 24, 3, 3)).save(
        src, "JPEG", quality=80, progressive=progressive)
    for i, (what, blob) in enumerate(_corrupt_variants(
            src.read_bytes(), progressive).items()):
        path = tmp_path / f"damaged_{i}.jpg"
        path.write_bytes(blob)
        assert _pillow_refuses(path), what
        with pytest.raises(ValueError, match=f"damaged_{i}.jpg"):
            images.read_rgb(path)


def test_jpeg_sequential_scan_takes_the_standard_tables(tmp_path):
    """A baseline file whose luminance DC table was left out (as
    Motion-JPEG frames leave the standard tables out) decodes with the
    standard table, as Pillow decodes it."""
    src = tmp_path / "src.jpg"
    Image.fromarray(_pixels(40, 24, 3, 3)).save(src, "JPEG", quality=80)
    path = tmp_path / "mjpeg.jpg"
    path.write_bytes(_without_first_dht(src.read_bytes()))
    _assert_reads_as_pillow(path)


def test_jpeg_frames_refused_by_name(tmp_path):
    """12-bit samples and a DNL height raise naming the file and the
    reason, from the header and the decoder.  A baseline stream under an
    arithmetic (SOF9) or lossless (SOF3) frame marker is what Pillow makes
    of it: the arithmetic decoder reads its bytes as arithmetic-coded data
    (garbage that Pillow decodes too); the lossless file is refused (a
    JFIF file is YCbCr, whose colors libjpeg-turbo does not convert in a
    lossless frame), with the frame's size from the header."""
    src = tmp_path / "src.jpg"
    Image.fromarray(_pixels(16, 8, 3, 4)).save(src, "JPEG")
    blob = src.read_bytes()
    sof = blob.index(b"\xff\xc0")
    cases = {
        "12-bit": blob[:sof + 4] + b"\x0c" + blob[sof + 5:],
        "DNL": blob[:sof + 5] + b"\x00\x00" + blob[sof + 7:],
    }
    for reason, data in cases.items():
        path = tmp_path / f"{reason}.jpg"
        path.write_bytes(data)
        assert _pillow_refuses(path)
        for read in (images.read_image_size, images.read_rgb):
            with pytest.raises(ValueError, match=reason):
                read(path)
    arith = tmp_path / "arithmetic-coded.jpg"
    arith.write_bytes(blob[:sof + 1] + b"\xc9" + blob[sof + 2:])
    _assert_reads_as_pillow(arith)
    lossless = tmp_path / "lossless.jpg"
    lossless.write_bytes(blob[:sof + 1] + b"\xc3" + blob[sof + 2:])
    assert _pillow_refuses(lossless)
    assert images.read_image_size(lossless) == (16, 8)
    with pytest.raises(ValueError, match="lossless.jpg: .*lossless"):
        images.read_rgb(lossless)


# ------------------------------------------------------------------ PNG
def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    h, w, c = samples.shape
    if depth == 16:
        return samples.astype(">u2").reshape(h, w * c).view(np.uint8)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * c)
    bits = ((samples[..., 0, None] >> np.arange(depth - 1, -1, -1)) & 1
            ).astype(np.uint8).reshape(h, w * depth)
    return np.packbits(bits, axis=1)


def write_png(path, samples, color, depth, interlace, plte=None,
              trns=None) -> None:
    """A PNG of ``samples`` [h, w, c] (filter 0 rows; each Adam7 pass on
    its own), with a PLTE and a tRNS chunk when given."""
    h, w, _ = samples.shape
    raw = b""
    for x0, y0, dx, dy in (png._ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            rows = _pack_rows(sub, depth)
            raw += np.concatenate([np.zeros((rows.shape[0], 1), np.uint8),
                                   rows], 1).tobytes()
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if plte is not None:
        out += _chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    Path(path).write_bytes(out + _chunk(b"IDAT", zlib.compress(raw))
                           + _chunk(b"IEND", b""))


def _random_png(path, color, depth, interlace, w, h, seed) -> None:
    rng = np.random.default_rng(seed)
    c = png._CHANNELS[color]
    samples = rng.integers(0, 1 << depth, (h, w, c)).astype(
        np.uint16 if depth == 16 else np.uint8)
    plte = trns = None
    if color == 3:  # a PLTE shorter than the indices reach
        plte = rng.integers(0, 256, (max(1, (1 << depth) // 2 + 1), 3))
        trns = bytes([7, 200])
    if color == 0 and depth == 16:
        samples[0, :, 0] = rng.integers(0, 256, w)  # under the clip too
    write_png(path, samples, color, depth, interlace, plte, trns)


_PNG_CASES = [(color, depth, interlace)
              for color, depths in sorted(png._DEPTHS.items())
              for depth in depths for interlace in (0, 1)]


@pytest.mark.parametrize("color,depth,interlace", _PNG_CASES)
def test_png_bit_exact_to_pillow(tmp_path, color, depth, interlace):
    for i, (w, h) in enumerate([(1, 1), (5, 3), (17, 9), (33, 20)]):
        path = tmp_path / f"{i}.png"
        _random_png(path, color, depth, interlace, w, h,
                    zlib.crc32(repr((color, depth, interlace, w)).encode()))
        _assert_reads_as_pillow(path)


@pytest.mark.parametrize("mode,kw", [
    ("1", {}), ("P", {"bits": 1}), ("P", {"bits": 2}), ("P", {"bits": 4}),
    ("P", {}), ("I;16", {}), ("LA", {}), ("RGBA", {"optimize": True})])
def test_png_pillow_written_read_as_pillow(tmp_path, mode, kw):
    rng = np.random.default_rng(11)
    a = rng.integers(0, 256, (21, 30, 3)).astype(np.uint8)
    img = Image.fromarray(a)
    if mode == "P":
        img = img.quantize(1 << kw.get("bits", 8))
    elif mode == "I;16":
        img = Image.fromarray(rng.integers(0, 1024, (21, 30)).astype(
            np.uint16))
    else:
        img = img.convert(mode)
    path = tmp_path / "p.png"
    img.save(path, **kw)
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


def _mixed_folder(tmp_path) -> Path:
    """JPEG (baseline 4:2:0, progressive, 4:4:4, gray), palette,
    16-bit RGB, 16-bit gray and Adam7 PNGs at four sizes, with
    captions."""
    d = tmp_path / "imgs"
    d.mkdir()
    sizes = [(64, 64), (80, 64), (70, 60), (64, 80)]
    jpegs = [("RGB", dict(subsampling=2)), ("RGB", dict(progressive=True)),
             ("RGB", dict(subsampling=0, restart_marker_rows=1)),
             ("L", {})]
    for i, (mode, kw) in enumerate(jpegs):
        w, h = sizes[i % 4]
        a = _pixels(w, h, 3 if mode == "RGB" else 1, i)
        Image.fromarray(a if mode == "RGB" else a[..., 0], mode).save(
            d / f"j{i}.jpg", "JPEG", quality=85, **kw)
    pngs = [(3, 8, 0), (2, 16, 0), (0, 16, 1), (6, 8, 1)]
    for i, (color, depth, interlace) in enumerate(pngs):
        w, h = sizes[(i + 1) % 4]
        _random_png(d / f"p{i}.png", color, depth, interlace, w, h, 20 + i)
    for i, p in enumerate(sorted(d.iterdir())):
        p.with_suffix(".txt").write_text(f"caption {i}, tag")
    return d


def test_precompute_on_mixed_files_writes_the_same_cache_as_jax(tmp_path):
    assert _jax_native_ready()
    d = _mixed_folder(tmp_path)
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
    assert len(td.image_paths) == 8
    assert jd.bucket_indices == td.bucket_indices
    for ds in (jd, td):
        assert ds.precompute(enc_i, enc_p, batch_size=2, center_crop=False,
                             random_flip=True) == 8
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
def test_generate_init_jpeg_and_palette_mask_match_jax(tmp_path, src, dst):
    h, w = src
    init = tmp_path / "init.jpg"
    Image.fromarray(_pixels(w, h, 3, 5)).save(init, "JPEG", quality=90,
                                               progressive=True)
    mask = tmp_path / "mask.png"
    rng = np.random.default_rng(6)
    Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
                    ).quantize(16).save(mask)
    assert Image.open(mask).mode == "P"
    th, tw = dst
    np.testing.assert_array_equal(
        generate._load_images([init], th, tw)[0],
        jax_generate._load_images([str(init)], th, tw)[0])
    np.testing.assert_array_equal(
        generate._load_masks([mask], th, tw)[0],
        jax_generate._load_masks([str(mask)], th, tw)[0])


def test_decode_from_threads_at_once_on_a_cold_build(tmp_path, monkeypatch):
    """More threads than cores decode at once, with a short switch
    interval, while the library builds for the first time: one build,
    and each thread gets the serial result."""
    path = tmp_path / "t.jpg"
    Image.fromarray(_pixels(96, 64, 3, 7)).save(path, "JPEG", quality=90)
    want = np.asarray(Image.open(path).convert("RGB"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.load_jpeg.cache_clear()
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
        native.load_jpeg.cache_clear()
    assert not errors, errors
    assert len(list((tmp_path / "build").iterdir())) == 1
    for got in out:
        assert np.array_equal(got, want)


def test_other_formats_raise_naming_them(tmp_path):
    for name, blob, what in [
            ("a.webp", b"RIFF\x10\x00\x00\x00WEBPVP8 ",
             "truncated file.*WebP"),
            ("b.gif", b"GIF89a" + bytes(20), "GIF"),
            ("c.png", b"BM" + bytes(40), "not a JPEG, PNG or WebP")]:
        path = tmp_path / name
        path.write_bytes(blob)
        for read in (images.read_image_size, images.read_rgb,
                     images.read_gray):
            with pytest.raises(ValueError, match=f"{name}.*{what}"):
                read(path)
    # a JPEG named .png is read as what its bytes say
    path = tmp_path / "d.png"
    Image.fromarray(_pixels(9, 7, 3, 8)).save(path, "JPEG")
    _assert_reads_as_pillow(path)
