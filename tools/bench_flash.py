"""Time the PyTorch port's flash-attention kernels beside PyTorch's own
scaled-dot-product attention, on one CUDA card.

    python tools/bench_flash.py [label [out.json]]

Imports ``sdxl_training_improvements_tpu_torch`` from ``sys.path``, so the
same script times another checkout of the port when ``PYTHONPATH`` names
it (to compare two versions in one call: parent, change, change, parent).
For each of the SDXL attention sites of the b2 serving step and the b4
training step it prints, one JSON line per site (and all of them to
``out.json`` when given):

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
whole backward) over the time, beside the 989 TFLOP/s bf16 dense peak.
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

PEAK_FLOPS = 989e12
FWD_SHAPES = (  # (B, S, T, H, D): the b2 serving step's sites
    (2, 4096, 4096, 10, 64), (2, 4096, 77, 10, 64),
    (2, 1024, 1024, 20, 64), (2, 1024, 77, 20, 64))
BWD_SHAPES = tuple((4,) + s[1:] for s in FWD_SHAPES)  # the b4 train step's


def _inputs(b, s, t, h, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((b, n, h, d), generator=g, device="cuda"
                             ).bfloat16() for n in (s, t, t, s))


def main(label: str, out_path=None) -> None:
    from sdxl_training_improvements_tpu_torch.ops import flash_attention as F
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{label}: {F.__file__} on {smi}", flush=True)
    rows = []
    for b, s, t, h, d in FWD_SHAPES:
        q, k, v, dout = _inputs(b, s, t, h, d, seed=0)
        ms = time_ms(lambda: F.flash_attention_fwd_cuda(q, k, v))
        flops = 4 * b * h * s * t * d
        row = dict(kind="fwd", shape=[b, s, t, h, d], ms=ms,
                   dev=device_ms(lambda: F.flash_attention_fwd_cuda(q, k, v)),
                   tflops=flops / ms / 1e9,
                   share_of_peak=flops / PEAK_FLOPS * 1e3 / ms)
        row["sdpa_ms"], row["sdpa_backend"], row["sdpa_dev"] = sdpa_ms(
            q, k, v)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del q, k, v, dout
    for b, s, t, h, d in BWD_SHAPES:
        q, k, v, dout = _inputs(b, s, t, h, d, seed=1)
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
        row = dict(kind="bwd", shape=[b, s, t, h, d], dq_ms=dq_ms,
                   dkv_ms=dkv_ms, delta_ms=delta_ms, total_ms=total,
                   dq_tflops=6 * work / dq_ms / 1e9,
                   dkv_tflops=8 * work / dkv_ms / 1e9,
                   dkv_share_of_peak=8 * work / PEAK_FLOPS * 1e3 / dkv_ms,
                   total_tflops=14 * work / total / 1e9, **dev)
        row["sdpa_ms"], row["sdpa_backend"], row["sdpa_dev"] = sdpa_ms(
            q, k, v, dout)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del q, k, v, dout, out, lse, delta, args
        torch.cuda.empty_cache()
    if out_path is not None:
        Path(out_path).write_text(
            json.dumps({"label": label, "card": smi, "rows": rows}, indent=1))


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    main(*(sys.argv[1:3] or ["run"]))
