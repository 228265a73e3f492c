"""Accuracy of the fp32 flash-attention kernels on one CUDA card.

    python tools/check_flash_f32.py [out.json]

The kernels (``csrc/flash_f32.cu`` forward, ``csrc/flash_bwd_f32.cu``
backward) multiply split TF32 operands, about 2^-21 a product where fp32
keeps 2^-24.  For each case this prints the max abs error of out and lse
(forward) and of dq, dk and dv (backward) over their max magnitude, for
the kernels and for the plain fp32 versions
(``flash_attention_fwd_reference``, ``flash_attention_bwd_reference`` on
the card, fp32 matmuls), each against the same function computed in
float64 throughout (``_float64``), and
the kernels against the plain fp32 ones; and whether each meets the fp32
bars of the card tests (forward: out and lse within 2e-5, and with q
scaled by 50, 1e-4 of max |out| and 4e-6 of max |lse|; backward: 1e-4 of
max |gradient|, atol 5e-5 / rtol 5e-4).  The cases: the training sites'
scale and q scaled by 50 (logits to ~214), where exp(S * scale - lse)
turns S's absolute error into P's relative one.  Each row also gives the
sha256 of each kernel output's bytes (``digest``; the backward's run on
the plain forward's out and lse, so that its inputs do not depend on the
forward kernel): the inputs come from a seed, so two checkouts' kernels
agree bit for bit where the digests do.
Imports the port from ``sys.path`` (``PYTHONPATH`` picks the checkout).
"""
from __future__ import annotations

import hashlib
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


def _float64(q, k, v, dout):
    """(out, lse, dq, dk, dv) of softmax attention in float64 throughout
    (the port's plain versions compute in fp32 whatever their inputs)."""
    q, k, v, dout = (x.double() for x in (q, k, v, dout))
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    del logits
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    delta = (dout * out).sum(-1).transpose(1, 2)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dout, v) - delta[..., None])
    ds *= scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    del ds
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout)
    return out, lse, dq, dk, dv


def _errors(a: torch.Tensor, ref: torch.Tensor) -> dict:
    a, ref = a.double(), ref.double()
    diff = (a - ref).abs()
    return {"max_rel": (diff.max() / ref.abs().max()).item(),
            "within_1e-4_of_max": bool(diff.max() <= 1e-4 * ref.abs().max()),
            "within_atol_rtol": bool((diff <= 5e-5 + 5e-4 * ref.abs()).all())}


def _fwd_errors(a: torch.Tensor, ref: torch.Tensor, rel_bar: float) -> dict:
    """Max abs error, and over max |ref|, against the forward's bars: 2e-5,
    and ``rel_bar`` of max |ref| (the large-logit case's)."""
    a, ref = a.double(), ref.double()
    err, top = (a - ref).abs().max().item(), ref.abs().max().item()
    return {"max_abs": err, "max_rel": err / top, "within_2e-5": err <= 2e-5,
            f"within_{rel_bar:g}_of_max": err <= rel_bar * top}


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
        out64, lse64, *exact = _float64(q, k, v, dout)
        plain_fwd = F.flash_attention_fwd_reference(q, k, v)
        row = {"shape": [b, s, t, h, d], "q_scale": q_scale, "digest": {
            name: hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()
            for name, x in zip(("out", "lse", "dq", "dk", "dv"), (
                out, lse, *F.flash_attention_bwd_cuda(q, k, v, *plain_fwd,
                                                      dout)))}}
        for name, a, p, e, bar in (("out", out, plain_fwd[0], out64, 1e-4),
                                   ("lse", lse, plain_fwd[1], lse64, 4e-6)):
            row[name] = {"kernel_vs_float64": _fwd_errors(a, e, bar),
                         "plain_vs_float64": _fwd_errors(p, e, bar),
                         "kernel_vs_plain": _fwd_errors(a, p, bar)}
        for name, a, p, e in zip(("dq", "dk", "dv"), kernel, plain, exact):
            row[name] = {"kernel_vs_float64": _errors(a, e),
                         "plain_vs_float64": _errors(p, e),
                         "kernel_vs_plain": _errors(a, p)}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del q, k, v, dout, out, lse, kernel, plain, exact, out64, lse64
        del plain_fwd
        torch.cuda.empty_cache()
    if out_path is not None:
        Path(out_path).write_text(json.dumps({"card": smi, "rows": rows},
                                             indent=1))


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    main(*sys.argv[1:2])
