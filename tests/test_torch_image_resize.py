"""PyTorch port: ``generate.py``'s ``--init`` / ``--mask`` of another size.

The port resizes with ``png.resize_lanczos`` / ``png.resize_nearest``
(numpy reproductions of Pillow's fixed-point resampling); JAX's
``generate._load_images`` / ``_load_masks`` call Pillow.  On seeded PNGs
the two must be ``np.array_equal``: up, down, odd to odd, one side kept,
1-pixel images and edges, RGBA and gray sources, and a mask whose values
straddle the 127 threshold.
"""
import zlib

import numpy as np
import pytest
from PIL import Image

from sdxl_training_improvements_tpu import generate as jax_generate
from sdxl_training_improvements_tpu_torch import generate, png

# (source height, width) -> (target height, width)
SIZES = [
    ((48, 64), (96, 128)),    # up
    ((100, 80), (32, 24)),    # down
    ((37, 53), (29, 61)),     # odd to odd, one side each way
    ((40, 33), (40, 96)),     # height kept
    ((1, 1), (17, 9)),        # one pixel, up
    ((1, 45), (8, 8)),        # a 1-pixel edge
    ((45, 1), (16, 3)),
    ((257, 300), (1024, 1024)),
]


def _source(shape, seed, mode):
    """Seeded pixels with smooth runs and noise, written by Pillow."""
    rng = np.random.default_rng(seed)
    channels = {"RGB": 3, "RGBA": 4, "L": 1}[mode]
    a = rng.integers(0, 256, shape + (channels,)).astype(np.uint8)
    a[::2] = (np.cumsum(rng.integers(0, 6, a[::2].shape), axis=1)
              % 256).astype(np.uint8)
    return Image.fromarray(a[..., 0] if channels == 1 else a, mode)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L"])
@pytest.mark.parametrize("src,dst", SIZES)
def test_init_images_match_pillow(tmp_path, src, dst, mode):
    path = tmp_path / "init.png"
    _source(src, zlib.crc32(repr((src, mode)).encode()), mode).save(path)
    h, w = dst
    got = generate._load_images([path], h, w)[0]
    want = jax_generate._load_images([str(path)], h, w)[0]
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", SIZES)
def test_masks_match_pillow(tmp_path, src, dst):
    rng = np.random.default_rng(7)
    # gray levels around the threshold: 126, 127, 128 and the extremes
    m = rng.choice(np.array([0, 126, 127, 128, 255], np.uint8), src)
    path = tmp_path / "mask.png"
    Image.fromarray(m, "L").save(path)
    h, w = dst
    got = generate._load_masks([path], h, w)[0]
    want = jax_generate._load_masks([str(path)], h, w)[0]
    assert got.shape == (h, w) and set(np.unique(got)) <= {0, 1}
    np.testing.assert_array_equal(got, want)
    # an RGB mask goes through Pillow's luma first
    Image.fromarray(np.repeat(m[..., None], 3, axis=2)).save(path)
    np.testing.assert_array_equal(
        generate._load_masks([path], h, w)[0],
        jax_generate._load_masks([str(path)], h, w)[0])


def test_resize_refuses_and_keeps(tmp_path):
    a = np.arange(24, dtype=np.uint8).reshape(2, 4, 3)
    np.testing.assert_array_equal(png.resize_lanczos(a, 4, 2), a)
    np.testing.assert_array_equal(png.resize_nearest(a[..., 0], 4, 2),
                                  a[..., 0])
    with pytest.raises(ValueError, match="uint8"):
        png.resize_lanczos(a.astype(np.float32), 3, 3)
    # an .npy mask (nonzero = repaint) is resized as one of 0 and 255
    np.save(tmp_path / "m.npy", np.eye(4, dtype=np.int64) * 3)
    got = generate._load_masks([tmp_path / "m.npy"], 8, 8)[0]
    np.testing.assert_array_equal(got, np.kron(np.eye(4, dtype=np.uint8),
                                               np.ones((2, 2), np.uint8)))
