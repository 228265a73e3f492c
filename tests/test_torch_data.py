"""PyTorch port: the data modules against the JAX package's.

* Buckets, the bucket sampler and tag weights give the JAX package's
  outputs from the same inputs and seeds.
* A cache written by the JAX package's ``CacheManager`` reads back
  bit-equal through the port's, and the other way round.
* ``png.read_png`` equals Pillow on Pillow-written files; the C++ row
  unfilter (``native.png_unfilter``) is byte-equal to the plain Python
  one (``png._unfilter``) on each of the five filters and on Pillow's
  adaptive files.
* What Pillow's ``Image.open`` refuses (a truncated WebP, a 12-bit
  arithmetic JPEG, an image past the decompression-bomb limit, as a
  PNG, a JPEG and a WebP) the readers refuse naming the file, and
  ``create_dataset`` skips it as JAX's bucketing does; a GIF, which
  Pillow reads, raises naming it; at 1.5x the limit the size is read.
* ``prepare_image_array`` is bit-equal to JAX's (both run the same C++),
  with the center and the random crop and with the flip; the precompute
  writes the same cache entries in both packages from the same PNGs.
* ``batches_for_epoch`` over one cache yields bit-equal batches in the
  same order in both packages, for epochs 0 and 1, with caption dropout
  and tag weighting on.
"""
import io
import logging
import struct
import time
import zlib

import numpy as np
import pytest
from PIL import Image

from sdxl_training_improvements_tpu import native as jax_native
from sdxl_training_improvements_tpu.config import Config as JConfig
from sdxl_training_improvements_tpu.data import buckets as JB
from sdxl_training_improvements_tpu.data import cache as JCa
from sdxl_training_improvements_tpu.data import dataset as JD
from sdxl_training_improvements_tpu.data import pipeline as JP
from sdxl_training_improvements_tpu.data import samplers as JS
from sdxl_training_improvements_tpu.data import tags as JT
from sdxl_training_improvements_tpu_torch import images, native, png
from sdxl_training_improvements_tpu_torch.config import Config as TConfig
from sdxl_training_improvements_tpu_torch.data import buckets as TB
from sdxl_training_improvements_tpu_torch.data import cache as TCa
from sdxl_training_improvements_tpu_torch.data import dataset as TD
from sdxl_training_improvements_tpu_torch.data import pipeline as TP
from sdxl_training_improvements_tpu_torch.data import samplers as TS
from sdxl_training_improvements_tpu_torch.data import tags as TT

IMAGE = {"min_size": [32, 32], "max_size": [96, 96], "bucket_step": 16}
CAPTIONS = ["masterpiece, 1girl, solo, smile", "landscape, lake, sunset",
            "best quality, cat, window", "1girl, armor, sword, night",
            "photorealistic, 85mm, bokeh, portrait", "watermark, sketch, cat",
            "", "lowres, dog"]


def _jax_native_ready() -> bool:
    """The JAX package's native library loaded (not its PIL fallback).
    Its build writes the library in place, so a test process that loads
    it while another is still writing it sees a failure: retry."""
    for _ in range(60):
        if jax_native.available():
            return True
        jax_native._tried = False
        time.sleep(0.5)
    return False


def _configs(raw=None):
    raw = raw or {}
    return JConfig.from_dict(raw), TConfig.from_dict(raw)


# ------------------------------------------------------------- buckets
@pytest.mark.parametrize("image", [{}, IMAGE, {"max_aspect_ratio": 1.5,
                                               "bucket_step": 32}])
def test_buckets_match_jax(image):
    jc, tc = _configs({"global_config": {"image": image}})
    jb, tb = JB.generate_buckets(jc), TB.generate_buckets(tc)
    assert [b.to_dict() for b in jb] == [b.to_dict() for b in tb]
    assert [b.to_dict() for b in JB.supported_dims_buckets(jc)] == \
        [b.to_dict() for b in TB.supported_dims_buckets(tc)]
    rng = np.random.default_rng(0)
    sizes = [tuple(int(x) for x in s)
             for s in rng.integers(16, 2000, (300, 2))]
    for s in sizes:
        a, b = JB.assign_bucket(s, jb), TB.assign_bucket(s, tb)
        assert (a is None and b is None) or a.to_dict() == b.to_dict(), s
        for bucket_j, bucket_t in zip(jb[:5], tb[:5]):
            assert JB.validate_bucket(bucket_j, jc.global_config.image) == \
                TB.validate_bucket(bucket_t, tc.global_config.image)
    paths = {f"p{i}": s for i, s in enumerate(sizes)}
    assert JB.group_images_by_bucket(paths, jb) == \
        TB.group_images_by_bucket(paths, tb)


@pytest.mark.parametrize("shuffle,drop_last,shards", [
    (True, True, 1), (False, True, 1), (True, False, 1), (True, True, 3)])
def test_bucket_sampler_matches_jax(shuffle, drop_last, shards):
    rng = np.random.default_rng(1)
    buckets = {(128, 128): list(range(0, 23)), (104, 152): list(range(23, 40)),
               (152, 104): list(rng.permutation(np.arange(40, 51)))}
    for shard in range(shards):
        for seed in (0, 7):
            kw = dict(batch_size=4, shuffle=shuffle, seed=seed,
                      drop_last=drop_last, num_shards=shards, shard=shard)
            js, ts = JS.BucketBatchSampler(buckets, **kw), \
                TS.BucketBatchSampler(buckets, **kw)
            for epoch in (0, 1, 5):
                js.set_epoch(epoch)
                ts.set_epoch(epoch)
                assert list(js.iter_with_buckets()) == \
                    list(ts.iter_with_buckets())
                assert len(js) == len(ts)


def test_tag_weights_match_jax():
    tags = ["style:anime", "masterpiece", "85mm", "watermark", "cat",
            "oil painting", "best_quality", "meta:foo", "f/1.8", "lowres"]
    assert [JT.categorize_tag(t) for t in tags] == \
        [TT.categorize_tag(t) for t in tags]
    captions = CAPTIONS * 3 + ["cat, cat, dog", "sketch"]
    jw = JT.TagWeighter(min_weight=0.2, max_weight=2.5, smoothing_factor=0.1)
    tw = TT.TagWeighter(min_weight=0.2, max_weight=2.5, smoothing_factor=0.1)
    jw.update_statistics(captions)
    tw.update_statistics(captions)
    assert jw.to_index() == tw.to_index()
    np.testing.assert_array_equal(jw.get_batch_weights(captions),
                                  tw.get_batch_weights(captions))
    back = TT.TagWeighter.from_index(jw.to_index())
    np.testing.assert_array_equal(back.get_batch_weights(captions),
                                  jw.get_batch_weights(captions))


# --------------------------------------------------------------- cache
def _entry(rng, h=16, w=16):
    return dict(vae_latents=rng.standard_normal((4, h, w)).astype(np.float32),
                time_ids=rng.standard_normal(6).astype(np.float32),
                prompt_embeds=rng.standard_normal((77, 64)).astype(
                    np.float32),
                pooled_prompt_embeds=rng.standard_normal(32).astype(
                    np.float32))


@pytest.mark.parametrize("writer,reader", [(JCa, TCa), (TCa, JCa)],
                         ids=["jax_to_port", "port_to_jax"])
def test_cache_interchange(tmp_path, writer, reader):
    rng = np.random.default_rng(2)
    w = writer.CacheManager(tmp_path / "c", index_save_every=2)
    entries = {}
    for i in range(5):
        key = w.get_cache_key(f"/data/img{i}.png")
        entries[key] = _entry(rng)
        w.save_latents(key, **entries[key],
                       metadata={"original_size": [64, 80], "caption": "x"})
    empty = _entry(rng)
    w.save_empty_prompt(empty["prompt_embeds"], empty["pooled_prompt_embeds"])
    w.save_tag_index({"config": {"min_weight": 0.1}, "counts": {}})
    w.flush()
    r = reader.CacheManager(tmp_path / "c")
    assert r.index == w.index
    assert r.get_cache_key("/data/img3.png") == w.get_cache_key(
        "/data/img3.png")
    for key, arrays in entries.items():
        got = r.load_latents(key)
        for k, v in arrays.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
        assert got["metadata"]["original_size"] == [64, 80]
    e = r.load_empty_prompt()
    assert np.array_equal(e["prompt_embeds"], empty["prompt_embeds"])
    assert r.load_tag_index() == {"config": {"min_weight": 0.1},
                                  "counts": {}}
    assert r.verify_and_prune() == (5, 0)


# ----------------------------------------------------------------- PNG
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
def test_read_png_matches_pillow(tmp_path, mode):
    rng = np.random.default_rng(3)
    h, w = 37, 53
    y, x = np.mgrid[0:h, 0:w]
    smooth = np.stack([x * 4, y * 6, x + y, (x * y) % 256], -1) % 256
    arr = np.clip(smooth + rng.integers(-8, 9, smooth.shape), 0, 255).astype(
        np.uint8)
    chans = {"RGB": 3, "RGBA": 4, "L": 1, "LA": 2}[mode]
    img = Image.fromarray(arr[..., :chans].squeeze(), mode)
    path = tmp_path / "x.png"
    img.save(path, optimize=True)
    ours = png.read_png(path)
    assert np.array_equal(ours, np.asarray(Image.open(path)))
    assert images.read_image_size(path) == (w, h)


def _filtered_rows(rng, h, stride, kinds):
    raw = rng.integers(0, 256, (h, stride + 1), dtype=np.uint8)
    raw[:, 0] = kinds
    return raw.tobytes()


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_native_unfilter_matches_plain_on_every_filter(bpp):
    rng = np.random.default_rng(bpp)
    h, stride = 30, 7 * bpp
    for kinds in ([0] * h, [1] * h, [2] * h, [3] * h, [4] * h,
                  rng.integers(0, 5, h)):
        data = _filtered_rows(rng, h, stride, kinds)
        assert np.array_equal(native.png_unfilter(data, h, stride, bpp),
                              png._unfilter(data, h, stride, bpp))


def test_native_unfilter_matches_plain_on_pillow_files(tmp_path):
    rng = np.random.default_rng(4)
    y, x = np.mgrid[0:64, 0:96]
    arr = np.stack([x * 2, y * 3, (x * y) % 256], -1)
    arr = np.clip(arr + rng.integers(-5, 6, arr.shape), 0, 255).astype(
        np.uint8)
    path = tmp_path / "p.png"
    Image.fromarray(arr).save(path, optimize=True)
    blob = path.read_bytes()
    idat, pos = b"", 8
    while pos < len(blob):
        n = int.from_bytes(blob[pos:pos + 4], "big")
        if blob[pos + 4:pos + 8] == b"IDAT":
            idat += blob[pos + 8:pos + 8 + n]
        pos += 12 + n
    data = zlib.decompress(idat)
    kinds = {data[r * (96 * 3 + 1)] for r in range(64)}
    assert len(kinds) > 1  # adaptive: several filters in one file
    assert np.array_equal(native.png_unfilter(data, 64, 96 * 3, 3),
                          png._unfilter(data, 64, 96 * 3, 3))
    with pytest.raises(ValueError, match="unknown filter type 7"):
        native.png_unfilter(b"\x07" + bytes(3), 1, 3, 3)


def _unread_image(path, kind: str) -> None:
    """A file at ``path`` the port does not read: a GIF that Pillow
    writes (and reads), Pillow's WebP cut short of its RIFF size, or
    Pillow's baseline JPEG with its frame header made SOF9 (arithmetic
    coding) of 12-bit samples (neither of which Pillow identifies)."""
    img = Image.fromarray(np.zeros((8, 8, 3), np.uint8))
    if kind == "arithmetic":
        img.save(path, "JPEG")
        blob = path.read_bytes()
        path.write_bytes(blob.replace(b"\xff\xc0\x00\x11\x08",
                                      b"\xff\xc9\x00\x11\x0c", 1))
    else:
        img.save(path, kind.upper())
    if kind == "webp":
        blob = path.read_bytes()
        path.write_bytes(blob[:len(blob) // 2])


def _bomb(path, kind: str, w: int, h: int) -> None:
    """A tiny file of a ``w`` x ``h`` image: a PNG of IHDR and IEND,
    Pillow's 8x8 JPEG with its frame header's size set, or a lossless
    WebP (VP8L) whose five prefix codes each have one symbol, so that
    every pixel costs 0 bits (a black image of any size in 28 bytes)."""
    if kind == "png":
        path.write_bytes(png._SIGNATURE + png._chunk(
            b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + png._chunk(b"IEND", b""))
    elif kind == "jpeg":
        b = io.BytesIO()
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(b, "JPEG")
        blob = b.getvalue()
        at = blob.index(b"\xff\xc0") + 5
        path.write_bytes(blob[:at] + struct.pack(">HH", h, w)
                         + blob[at + 4:])
    else:
        # signature, 14-bit sides less one, no alpha, version 0; no
        # transform, no color cache, no meta codes; five simple codes of
        # one 1-bit symbol (0)
        fields = [(0x2F, 8), (w - 1, 14), (h - 1, 14), (0, 1), (0, 3),
                  (0, 1), (0, 1), (0, 1)] + [(1, 1), (0, 1), (0, 1),
                                             (0, 1)] * 5
        bits = n = 0
        for v, k in fields:
            bits |= v << n
            n += k
        vp8l = bits.to_bytes((n + 7) // 8, "little")
        vp8l += b"\0" * (len(vp8l) & 1)
        body = b"WEBP" + b"VP8L" + struct.pack("<I", len(vp8l)) + vp8l
        path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


def _skip_configs(tmp_path, d):
    """The two packages' configs over ``d`` with their caches apart."""
    def raw(side):
        return {"data": {"train_data_dir": [str(d)]},
                "global_config": {"image": IMAGE, "cache": {
                    "cache_dir": str(tmp_path / f"cache_{side}")}}}
    return JConfig.from_dict(raw("j")), TConfig.from_dict(raw("t"))


def _assert_skipped_as_jax(tmp_path, caplog, d, names, n_read) -> None:
    """``create_dataset`` over ``d`` buckets as JAX's does (``n_read``
    images) and logs each of ``names`` as skipped."""
    jc, tc = _skip_configs(tmp_path, d)
    with caplog.at_level(logging.WARNING, logger=TD.__name__):
        td = TD.create_dataset(tc)
    jd = JD.create_dataset(jc)
    assert td.bucket_indices == jd.bucket_indices
    assert sum(map(len, td.bucket_indices.values())) == n_read
    for name in names:
        assert f"skipping {d / name}" in caplog.text


@pytest.mark.parametrize("name,kind", [
    ("photo.webp", "webp"), ("photo.jpg", "arithmetic"),
    ("photo.jpeg", "gif")])
def test_non_png_image_raises_naming_it(tmp_path, caplog, name, kind):
    """Among readable images: a truncated WebP and a 12-bit arithmetic
    JPEG, which Pillow's ``Image.open`` refuses too, raise in the size
    reader (``images.ImageRefused``, naming the file) and are skipped by
    ``create_dataset`` as JAX's bucketing skips them; a GIF (under a
    JPEG name: the format is told by the bytes), which Pillow reads and
    JAX trains on, raises in both (``images.UnsupportedImage``)."""
    d = _png_dir(tmp_path, n=4)
    path = d / name
    _unread_image(path, kind)
    path.with_suffix(".txt").write_text("cat")
    if kind == "gif":
        with Image.open(path) as im:
            assert im.size == (8, 8)
        with pytest.raises(images.UnsupportedImage, match=name):
            images.read_image_size(path)
        with pytest.raises(images.UnsupportedImage, match=name):
            TD.create_dataset(_skip_configs(tmp_path, d)[1])
        return
    with pytest.raises((OSError, SyntaxError)):
        Image.open(path)
    with pytest.raises(images.ImageRefused, match=name):
        images.read_image_size(path)
    _assert_skipped_as_jax(tmp_path, caplog, d, [name], 4)


_BOMBS = {"png": (13380, 13380), "jpeg": (16384, 10923),
          "webp": (16384, 10923)}


@pytest.mark.parametrize("kind", sorted(_BOMBS))
def test_past_the_bomb_limit_refused_as_pillow(tmp_path, caplog,
                                               monkeypatch, kind):
    """A header past Pillow's decompression-bomb limit (max(1, w) *
    max(1, h) > 2 * ``MAX_IMAGE_PIXELS``): ``Image.open`` raises
    ``DecompressionBombError``; the three readers and ``generate.py``'s
    ``--init`` / ``--mask`` loaders raise ``images.ImageRefused`` naming
    the file and the limit, before any decoder runs; the bucketing skips
    it as JAX's does."""
    assert images.MAX_IMAGE_PIXELS == Image.MAX_IMAGE_PIXELS
    w, h = _BOMBS[kind]
    assert w * h > 2 * Image.MAX_IMAGE_PIXELS
    d = _png_dir(tmp_path, n=4)
    name = f"bomb.{kind}"
    _bomb(d / name, kind, w, h)
    (d / "bomb.txt").write_text("cat")
    with pytest.raises(Image.DecompressionBombError):
        Image.open(d / name)

    def no_decode(*args, **kwargs):
        raise AssertionError("a decoder ran before the pixel check")
    for fn in ("jpeg_decode", "webp_decode"):
        monkeypatch.setattr(native, fn, no_decode)
    monkeypatch.setattr(png, "read_png_as", no_decode)
    from sdxl_training_improvements_tpu_torch import generate
    for read in (images.read_image_size, images.read_rgb, images.read_gray,
                 lambda p: generate._load_images([p], 64, 64),
                 lambda p: generate._load_masks([p], 64, 64)):
        with pytest.raises(images.ImageRefused,
                           match=rf"{name}: a {w}x{h} image.*178956970"):
            read(d / name)
    monkeypatch.undo()
    _assert_skipped_as_jax(tmp_path, caplog, d, [name], 4)


@pytest.mark.parametrize("kind,size", [("png", (11586, 11586)),
                                       ("jpeg", (16384, 8192))])
def test_between_one_and_two_limits_reads_the_size(tmp_path, kind, size):
    """At ~1.5x ``MAX_IMAGE_PIXELS`` Pillow only warns: the size is read,
    as ``Image.open`` reads it."""
    path = tmp_path / f"big.{kind}"
    _bomb(path, kind, *size)
    assert Image.MAX_IMAGE_PIXELS < size[0] * size[1] < (
        2 * Image.MAX_IMAGE_PIXELS)
    with pytest.warns(Image.DecompressionBombWarning):
        with Image.open(path) as im:
            assert im.size == size
    assert images.read_image_size(path) == size


def _png_case(case: str) -> bytes:
    """An 8x8 RGB PNG with its chunks laid out or damaged as ``case``
    says (None for a file of the signature alone)."""
    ihdr = png._chunk(b"IHDR", struct.pack(">IIBBBBB", 8, 8, 8, 2, 0, 0, 0))
    idat = png._chunk(b"IDAT", zlib.compress(bytes(8 * 25)))
    text, end = png._chunk(b"tEXt", b"a\0b"), png._chunk(b"IEND", b"")
    chunks = {
        "text_first": text + ihdr + idat + end,
        "bad_ihdr_crc": ihdr[:-1] + bytes([ihdr[-1] ^ 1]) + idat + end,
        "bad_text_crc": text[:-1] + bytes([text[-1] ^ 1]) + ihdr + idat + end,
        "bad_chunk_type": png._chunk(b"t#Xt", b"a") + ihdr + idat + end,
        "zero_width": png._chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 0, 8, 8, 2, 0, 0, 0)) + idat + end,
        "no_mode": png._chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 8, 8, 8, 5, 0, 0, 0)) + idat + end,
        "filter_method": png._chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 8, 8, 8, 2, 0, 1, 0)) + idat + end,
        "iend_first": end + ihdr + idat,
        "signature_only": b"",
        "idat_first": idat + ihdr + end}[case]
    return png._SIGNATURE + chunks


@pytest.mark.parametrize("case,read", [
    ("text_first", True), ("bad_ihdr_crc", False), ("bad_text_crc", False),
    ("bad_chunk_type", False), ("zero_width", False), ("no_mode", False),
    ("filter_method", False), ("iend_first", False),
    ("signature_only", False), ("idat_first", None)])
def test_png_header_read_and_refused_as_pillow(tmp_path, case, read):
    """The PNG size reader walks the chunks up to IHDR as Pillow's PNG
    reader does: the size where ``Image.open`` gives it,
    ``images.ImageRefused`` where it refuses the file, and
    ``images.UnsupportedImage`` for an IDAT before IHDR, whose size
    Pillow takes from the later IHDR (and whose pixels it cannot load)."""
    path = tmp_path / f"{case}.png"
    path.write_bytes(_png_case(case))
    if read is False:
        with pytest.raises((OSError, SyntaxError)):
            Image.open(path)
        with pytest.raises(images.ImageRefused, match=path.name):
            images.read_image_size(path)
        return
    with Image.open(path) as im:
        assert im.size == (8, 8)
    if read:
        assert images.read_image_size(path) == (8, 8)
    else:
        with pytest.raises(images.UnsupportedImage, match=path.name):
            images.read_image_size(path)


def test_create_dataset_skips_what_jax_skips(tmp_path, caplog):
    """One directory of readable PNGs, a cut WebP, a 12-bit SOF9 JPEG and
    the three files past the bomb limit: the same ``bucket_indices`` as
    JAX's ``create_dataset``, every skipped file named in the log; a GIF
    added there raises, naming it."""
    d = _png_dir(tmp_path, n=6)
    skipped = ["cut.webp", "sof9.jpg", "bomb.png", "bomb.jpeg", "bomb.webp"]
    _unread_image(d / "cut.webp", "webp")
    _unread_image(d / "sof9.jpg", "arithmetic")
    for kind in _BOMBS:
        _bomb(d / f"bomb.{kind}", kind, *_BOMBS[kind])
    _assert_skipped_as_jax(tmp_path, caplog, d, skipped, 6)
    _unread_image(d / "anim.jpg", "gif")
    with pytest.raises(images.UnsupportedImage, match="anim.jpg"):
        TD.create_dataset(_skip_configs(tmp_path, d)[1])


# ------------------------------------------------------- image prep
@pytest.mark.parametrize("size,center_crop,flip", [
    ((96, 64), True, False), ((96, 64), False, False), ((50, 77), True, True),
    ((50, 77), False, True), ((64, 64), True, False)])
def test_prepare_image_array_bit_equal_to_jax(size, center_crop, flip):
    assert _jax_native_ready()  # JAX's native path, not its PIL one
    w, h = size
    rgb = np.random.default_rng(5).integers(0, 256, (h, w, 3),
                                            dtype=np.uint8)
    bucket = JB.Bucket(48, 64)
    ref = JD.prepare_image_array(Image.fromarray(rgb), bucket,
                                 center_crop=center_crop, flip=flip,
                                 rng=np.random.default_rng(9))
    ours = TD.prepare_image_array(rgb, TB.Bucket(48, 64),
                                  center_crop=center_crop, flip=flip,
                                  rng=np.random.default_rng(9))
    assert ours[1:] == ref[1:]
    assert ours[0].dtype == ref[0].dtype and np.array_equal(ours[0], ref[0])


def _png_dir(tmp_path, n=8):
    rng = np.random.default_rng(6)
    d = tmp_path / "imgs"
    d.mkdir()
    sizes = [(64, 64), (80, 64), (70, 60), (64, 80)]
    for i in range(n):
        w, h = sizes[i % len(sizes)]
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(d / f"i{i}.png")
        (d / f"i{i}.txt").write_text(CAPTIONS[i])
    return d


def test_precompute_writes_the_same_cache_as_jax(tmp_path):
    assert _jax_native_ready()
    d = _png_dir(tmp_path)
    raw = {"data": {"train_data_dir": [str(d)]},
           "global_config": {"image": IMAGE}}
    jc, tc = _configs(raw)

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


# ------------------------------------------------------------- batches
def test_batches_for_epoch_bit_equal_to_jax(tmp_path):
    rng = np.random.default_rng(7)
    n = 20
    paths = [str(tmp_path / f"img{i}.png") for i in range(n)]
    captions = [CAPTIONS[i % len(CAPTIONS)] for i in range(n)]
    sizes = [(64, 64), (80, 64), (64, 80)]
    cm = JCa.CacheManager(tmp_path / "cache")
    for i, p in enumerate(paths):
        w, h = sizes[i % 3]
        e = _entry(rng, h // 8, w // 8)
        cm.save_latents(cm.get_cache_key(p), **e,
                        metadata={"original_size": [h, w]})
    empty = _entry(rng)
    cm.save_empty_prompt(empty["prompt_embeds"], empty["pooled_prompt_embeds"])
    cm.flush()
    raw = {"global_config": {"image": IMAGE},
           "tag_weighting": {"enable_tag_weighting": True}}
    jc, tc = _configs(raw)
    jcm, tcm = JCa.CacheManager(tmp_path / "cache"), \
        TCa.CacheManager(tmp_path / "cache")
    jd = JD.AspectBucketDataset(jc, paths, captions, jcm,
                                JT.create_tag_weighter_with_index(
                                    jc, captions, jcm))
    td = TD.AspectBucketDataset(tc, paths, captions, tcm,
                                TT.create_tag_weighter_with_index(
                                    tc, captions, tcm))
    assert jd.bucket_indices == td.bucket_indices
    assert len(jd.bucket_indices) == 3
    assert JP.check_shard_integrity(jd, 2, seed=3, process_count=1) == \
        TP.check_shard_integrity(td, 2, seed=3)
    for epoch in (0, 1):
        jb = list(JP.batches_for_epoch(jd, 2, epoch=epoch, seed=3,
                                       proportion_empty_prompts=0.4))
        tb = list(TP.batches_for_epoch(td, 2, epoch=epoch, seed=3,
                                       proportion_empty_prompts=0.4))
        assert len(jb) == len(tb) > 0
        dropped = 0
        for a, b in zip(jb, tb):
            assert a.keys() == b.keys() and "tag_weights" in b
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
            dropped += int((b["pooled_prompt_embeds"]
                            == empty["pooled_prompt_embeds"]).all(-1).sum())
        assert dropped > 0  # the caption dropout is exercised


def test_adapt_time_ids_and_prefetch_on_cpu():
    batch = {"time_ids": np.asarray([[64, 64, 0, 0, 64, 64]], np.float32)}
    np.testing.assert_array_equal(
        TP.adapt_batch_time_ids(batch, 5, 6.0)["time_ids"],
        JP.adapt_batch_time_ids(batch, 5, 6.0)["time_ids"])
    with pytest.raises(ValueError, match="cannot adapt"):
        TP.adapt_batch_time_ids(batch, 4)
    out = list(TP.prefetch_to_device(iter([batch, batch]), "cpu"))
    assert len(out) == 2 and np.array_equal(out[1]["time_ids"].numpy(),
                                            batch["time_ids"])


def test_prefetch_worker_errors_propagate():
    def gen():
        yield {"x": np.zeros((2, 2), np.float32)}
        raise RuntimeError("worker exploded")

    it = TP.prefetch_to_device(gen(), "cpu", prefetch=1)
    next(it)
    with pytest.raises(RuntimeError, match="worker exploded"):
        list(it)


def test_partitioned_cache_over_processes_raises(tmp_path):
    """Refused until the multi-process loop was ported: now a partitioned
    cache over 2 processes deals each rank JAX's index lists
    (``partition_for_host``, pure: no collective), and ``create_dataset``
    puts the rank's cache under ``host-NNN``."""
    buckets = {(64, 64): list(range(7)), (80, 64): [7, 8],
               (64, 80): [9], (96, 64): list(range(10, 16))}
    for rank in (0, 1):
        jd = object.__new__(JD.AspectBucketDataset)
        td = object.__new__(TD.AspectBucketDataset)
        for d in (jd, td):
            d.bucket_indices = {k: list(v) for k, v in buckets.items()}
        JD.AspectBucketDataset.partition_for_host(jd, 2, rank)
        TD.AspectBucketDataset.partition_for_host(td, 2, rank)
        assert td.bucket_indices == jd.bucket_indices
        assert sum(map(len, td.bucket_indices.values())) == 7
        with pytest.raises(ValueError, match="re-partition"):
            td.partition_for_host(2, 1 - rank)
    cfg = TConfig.from_dict({"global_config": {"cache": {
        "partitioned": True, "cache_dir": str(tmp_path)}},
        "data": {"train_data_dir": [str(tmp_path / "none")]}})
    ds = TD.create_dataset(cfg, process_count=2, process_index=1)
    assert ds.cache.cache_dir == tmp_path / "host-001"
    assert ds._partition == (2, 1)


def test_native_build_from_threads_at_once(tmp_path, monkeypatch):
    """A cold build reached by several threads of one process (the
    precompute's decode threads) builds once: each thread gets the
    library, and no image is skipped for a temporary file another thread
    renamed away."""
    import threading
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    out, errors = [], []

    def build():
        try:
            out.append(native.build())
        except Exception as e:  # reported below
            errors.append(e)
    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(set(out)) == 1 and out[0].exists()
    assert sorted(p.name for p in tmp_path.iterdir()) == [out[0].name]
