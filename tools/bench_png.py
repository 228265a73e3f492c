"""Time the PNG row unfilter: the C++ path against the plain Python one.

    PYTHONPATH=. python tools/bench_png.py [out.json]

Builds 1024x1024 RGB image data whose rows all use the Paeth filter (what
Pillow's adaptive encoder picks for most rows of a photo), checks that
``native.png_unfilter`` and the plain ``png._unfilter`` give the same
bytes, and prints (and writes) the median host time of each over 5 calls.
This measures the host CPU it runs on, not a device.
"""
import json
import platform
import statistics
import sys
import time

import numpy as np

from sdxl_training_improvements_tpu_torch import native, png


def _median_ms(fn, repeats: int = 5) -> float:
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> None:
    h, w, bpp = 1024, 1024, 3
    rows = np.random.default_rng(0).integers(0, 256, (h, w * bpp + 1),
                                             dtype=np.uint8)
    rows[:, 0] = 4  # Paeth
    data = rows.tobytes()
    out = native.png_unfilter(data, h, w * bpp, bpp)
    assert np.array_equal(out, png._unfilter(data, h, w * bpp, bpp))
    res = {"image": f"{w}x{h} RGB, every row Paeth",
           "host": platform.processor() or platform.machine(),
           "native_ms": _median_ms(
               lambda: native.png_unfilter(data, h, w * bpp, bpp)),
           "plain_ms": _median_ms(
               lambda: png._unfilter(data, h, w * bpp, bpp), repeats=3)}
    print(json.dumps(res))
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(res, f)


if __name__ == "__main__":
    main()
