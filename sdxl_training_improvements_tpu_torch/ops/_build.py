"""Build the CUDA C++ kernels of ``csrc/`` at first use.

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  Libraries go to ``_build/`` inside the package, named by a hash
of the source and the flags, so an edited kernel is rebuilt and an
unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# per-source flags: the optimizer must not contract a*b+c into an FMA
EXTRA_FLAGS = {"fused_adamw": ("--fmad=false",)}
KERNELS = ("flash_fwd", "flash_bwd", "flash_f32", "flash_bwd_f32",
           "fused_adamw", "groupnorm")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise FileNotFoundError("nvcc not found on PATH or under CUDA_HOME")


def _target(name: str):
    """(source, flags, library path) of ``csrc/<name>.cu``; the name
    hashes the source, the shared headers and the flags."""
    src = CSRC / f"{name}.cu"
    flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, ())
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(flags).encode()).hexdigest()[:16]
    return src, flags, BUILD_DIR / f"lib{name}_{digest}.so"


def build_all(names, verbose: bool = False) -> Dict[str, Path]:
    """Compile every stale ``csrc/<name>.cu`` at once, one ``nvcc`` process
    per source, all started together.  ``verbose`` adds ``-Xptxas -v`` and
    prints what it reports (registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in names:
        src, flags, lib = _target(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *flags, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(src)]
        running.append((src, tmp, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for src, tmp, lib, proc in running:
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{out}\n{err}")
        if verbose:
            print(f"nvcc {src.name}:\n{err.strip()}", flush=True)
        os.replace(tmp, lib)
    return {name: _target(name)[2] for name in names}


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    return build_all([name])[name]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    return ctypes.CDLL(str(build(name)))
