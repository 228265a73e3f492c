"""Time the PyTorch port's flash-attention kernels beside PyTorch's own
scaled-dot-product attention, on one CUDA card.

    python tools/bench_flash.py [label [out.json [dtype]]]

Imports ``sdxl_training_improvements_tpu_torch`` from ``sys.path``, so the
same script times another checkout of the port when ``PYTHONPATH`` names
it (to compare two versions in one call: parent, change, change, parent).
``dtype`` is bf16 (the default), fp16 or fp32: the inputs' type, which
picks the kernels.  For each of the SDXL attention sites of the b2
serving step and the b4 training step, and for fp32 also those of the b1
512^2 step of ``configs/ddpm_512_smoke.yaml`` (``chip_smoke.py`` phase 9,
forward and backward) and, for the forward, phase 9's S=T=256 H20 site at
66 heads (``FILL_SHAPES``: 132 blocks of 128 q rows, one a streaming
multiprocessor, where the site itself launches 40), it prints one JSON
line per site (and all of them to ``out.json`` when given):

* the forward kernel, the dq kernel, the dk/dv kernel and Delta (the
  plain rowsum the backward needs), each as the median over 5 loops of 10
  back-to-back calls timed with CUDA events (``*_ms``: where the host
  cannot launch as fast as the card runs, this is the host's pace), and
  as the kernels' own device time per call from ``torch.profiler``
  (``*_dev``);
* ``torch.nn.functional.scaled_dot_product_attention`` forward, and its
  backward (``torch.autograd.grad`` of one output), under whichever of its
  flash, cuDNN and efficient backends has the least device time
  (``chip_smoke.sdpa_ms``), per call (``sdpa_ms``) and in device time
  (``sdpa_dev``, the measure to hold ``*_dev`` against).  The port never
  calls these.

The timers are ``chip_smoke.py``'s.

Rates are the flop counts (4 BHSTD forward, 6 dq, 8 dk/dv, 14 for the
whole backward) over the time, beside the peak of the kernels' units
(``chip_smoke.PEAK``: 989 TFLOP/s bf16/fp16 dense; fp32 at the split-TF32
rate, 495 / 3 TFLOP/s).
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

# the timers of this checkout's chip_smoke.py, loaded by path so that the
# port itself still comes from sys.path
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_smoke)
device_ms, sdpa_ms, time_ms = _smoke.device_ms, _smoke.sdpa_ms, _smoke.time_ms

DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16,
          "fp32": torch.float32}
FWD_SHAPES = (  # (B, S, T, H, D): the b2 serving step's sites
    (2, 4096, 4096, 10, 64), (2, 4096, 77, 10, 64),
    (2, 1024, 1024, 20, 64), (2, 1024, 77, 20, 64))
BWD_SHAPES = tuple((4,) + s[1:] for s in FWD_SHAPES)  # the b4 train step's
# the b1 512^2 fp32 step's sites (10 self- and cross-attention blocks at
# 32^2 latents, 60 at 16^2)
PHASE9_SHAPES = ((1, 1024, 1024, 10, 64), (1, 256, 256, 20, 64),
                 (1, 1024, 77, 10, 64), (1, 256, 77, 20, 64))
# phase 9's S=T=256 site with a full wave of the fp32 forward's blocks:
# against the site itself, whether its time is one block's latency
FILL_SHAPES = ((1, 256, 256, 66, 64),)


def _inputs(b, s, t, h, d, seed, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((b, n, h, d), generator=g, device="cuda"
                             ).to(dtype) for n in (s, t, t, s))


def main(label: str, out_path=None, dtype_name: str = "bf16") -> None:
    from sdxl_training_improvements_tpu_torch.ops import flash_attention as F
    dtype = DTYPES[dtype_name]
    peak = _smoke.PEAK[dtype]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{label}: {F.__file__} on {smi}, {dtype_name}", flush=True)
    rows = []
    fwd_shapes = FWD_SHAPES + (PHASE9_SHAPES + FILL_SHAPES
                               if dtype == torch.float32 else ())
    for b, s, t, h, d in fwd_shapes:
        q, k, v, dout = _inputs(b, s, t, h, d, 0, dtype)
        ms = time_ms(lambda: F.flash_attention_fwd_cuda(q, k, v))
        flops = 4 * b * h * s * t * d
        row = dict(kind="fwd", dtype=dtype_name, shape=[b, s, t, h, d],
                   ms=ms,
                   dev=device_ms(lambda: F.flash_attention_fwd_cuda(q, k, v)),
                   tflops=flops / ms / 1e9,
                   share_of_peak=flops / peak * 1e3 / ms)
        row["sdpa_ms"], row["sdpa_backend"], row["sdpa_dev"] = sdpa_ms(
            q, k, v)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del q, k, v, dout
    bwd_shapes = BWD_SHAPES + (PHASE9_SHAPES if dtype == torch.float32
                               else ())
    for b, s, t, h, d in bwd_shapes:
        q, k, v, dout = _inputs(b, s, t, h, d, 1, dtype)
        out, lse = F.flash_attention_fwd_cuda(q, k, v)
        scale = d ** -0.5
        delta = F.flash_attention_bwd_delta(out, dout)
        args = (q, k, v, dout, lse, delta, scale)
        dq_ms = time_ms(lambda: F.flash_bwd_dq_cuda(*args))
        dkv_ms = time_ms(lambda: F.flash_bwd_dkv_cuda(*args))
        delta_ms = time_ms(lambda: F.flash_attention_bwd_delta(out, dout))
        dev = {name: device_ms(fn) for name, fn in (
            ("dq_dev", lambda: F.flash_bwd_dq_cuda(*args)),
            ("dkv_dev", lambda: F.flash_bwd_dkv_cuda(*args)),
            ("delta_dev", lambda: F.flash_attention_bwd_delta(out, dout)))}
        work = b * h * s * t * d
        total = dq_ms + dkv_ms + delta_ms
        row = dict(kind="bwd", dtype=dtype_name, shape=[b, s, t, h, d],
                   dq_ms=dq_ms, dkv_ms=dkv_ms, delta_ms=delta_ms,
                   total_ms=total, dq_tflops=6 * work / dq_ms / 1e9,
                   dkv_tflops=8 * work / dkv_ms / 1e9,
                   dq_bound_ms=6 * work / peak * 1e3,
                   dkv_bound_ms=8 * work / peak * 1e3,
                   total_tflops=14 * work / total / 1e9, **dev)
        row["sdpa_ms"], row["sdpa_backend"], row["sdpa_dev"] = sdpa_ms(
            q, k, v, dout)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del q, k, v, dout, out, lse, delta, args
        torch.cuda.empty_cache()
    if out_path is not None:
        Path(out_path).write_text(
            json.dumps({"label": label, "card": smi, "dtype": dtype_name,
                        "rows": rows}, indent=1))


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    main(*(sys.argv[1:4] or ["run"]))
