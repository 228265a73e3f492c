"""Accuracy of the fp32 flash-attention backward kernels on one CUDA card.

    python tools/check_flash_f32.py [out.json]

The kernels (``csrc/flash_bwd_f32.cu``) multiply split TF32 operands,
about 2^-21 a product where fp32 keeps 2^-24.  For each case this prints
the max abs error of dq, dk and dv over their max magnitude, for the
kernels and for the plain fp32 backward (``flash_attention_bwd_reference``
on the card, fp32 matmuls), each against the same backward in float64,
and the kernels against the plain fp32 one; and whether each meets the
fp32 bars of the card tests (1e-4 of max |gradient|; atol 5e-5 / rtol
5e-4).  The cases: the training sites' scale and q scaled by 50 (logits
to ~214), where exp(S * scale - lse) turns S's absolute error into P's
relative one.  Imports the port from ``sys.path`` (``PYTHONPATH`` picks
the checkout).
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

CASES = (  # (B, S, T, H, D, q scale)
    (4, 4096, 4096, 10, 64, 1.0),
    (1, 1024, 77, 10, 64, 1.0),
    (1, 256, 256, 2, 64, 50.0),
    (1, 1000, 77, 2, 64, 50.0),
)


def _errors(a: torch.Tensor, ref: torch.Tensor) -> dict:
    a, ref = a.double(), ref.double()
    diff = (a - ref).abs()
    return {"max_rel": (diff.max() / ref.abs().max()).item(),
            "within_1e-4_of_max": bool(diff.max() <= 1e-4 * ref.abs().max()),
            "within_atol_rtol": bool((diff <= 5e-5 + 5e-4 * ref.abs()).all())}


def main(out_path=None) -> None:
    from sdxl_training_improvements_tpu_torch.ops import flash_attention as F
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{F.__file__} on {smi}", flush=True)
    rows = []
    for b, s, t, h, d, q_scale in CASES:
        g = torch.Generator("cuda").manual_seed(7)
        q, k, v, dout = (torch.randn((b, n, h, d), generator=g,
                                     device="cuda") for n in (s, t, t, s))
        q = q * q_scale
        out, lse = F.flash_attention_fwd_cuda(q, k, v)
        kernel = F.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
        plain = F.flash_attention_bwd_reference(q, k, v, out, lse, dout)
        q64, k64, v64, do64 = (x.double() for x in (q, k, v, dout))
        out64, lse64 = F.flash_attention_fwd_reference(q64, k64, v64)
        exact = F.flash_attention_bwd_reference(q64, k64, v64, out64, lse64,
                                                do64)
        row = {"shape": [b, s, t, h, d], "q_scale": q_scale}
        for name, a, p, e in zip(("dq", "dk", "dv"), kernel, plain, exact):
            row[name] = {"kernel_vs_float64": _errors(a, e),
                         "plain_vs_float64": _errors(p, e),
                         "kernel_vs_plain": _errors(a, p)}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del q, k, v, dout, out, lse, kernel, plain, exact, q64, k64, v64
        del do64, out64, lse64
        torch.cuda.empty_cache()
    if out_path is not None:
        Path(out_path).write_text(json.dumps({"card": smi, "rows": rows},
                                             indent=1))


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    main(*sys.argv[1:2])
