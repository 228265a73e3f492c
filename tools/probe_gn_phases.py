"""Where the device time of one GroupNorm+SiLU forward call goes, on one
CUDA card.

    python tools/probe_gn_phases.py

Builds with ``nvcc``, into the package's gitignored ``_build/``:

* a copy of ``csrc/groupnorm.cu`` in which thread 0 of every block of
  ``gn_silu_fwd_kernel`` writes ``%globaltimer`` (ns) at six points: its
  start, after the phase-1 stream, after the block's reduction to group
  partials, after the grid barrier, after the merge of the image's chunk
  partials, and at its end.  It runs through the port's own wrapper, so
  the launch shape is the kernel's own;
* empty kernels of the same launch shape (one 512-thread block with 192 KB
  of shared memory on each SM): launched plainly, cooperatively, and
  cooperatively with one and with two ``cooperative_groups`` grid
  barriers.

It prints, for each bf16 shape, the mean over blocks of each point's time
after the earliest block start (us), and the device time of each empty
kernel from ``torch.profiler`` (us): what the launch and one grid barrier
cost by themselves.
"""
from __future__ import annotations

import ctypes
import functools
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SHAPES = ((4, 1024, 640), (2, 1024, 2560), (2, 4096, 640), (4, 16384, 320))
POINTS = ("start", "phase 1 streamed", "block reduced", "grid barrier",
          "chunks merged", "end")

STAMP = '''namespace cg = cooperative_groups;
__device__ unsigned long long* g_times;
__device__ __forceinline__ void stamp(int k) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_times[blockIdx.x * 8 + k] = t;
  }
}
extern "C" int set_times(void* p) {
  return (int)cudaMemcpyToSymbol(g_times, &p, sizeof(p));
}
'''

EMPTY = r'''
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
template <int SYNCS>
__global__ void __launch_bounds__(512, 1) empty_kernel(int* out) {
  extern __shared__ unsigned char smem[];
  for (int i = 0; i < SYNCS; ++i) cg::this_grid().sync();
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = SYNCS;
}
extern "C" int launch_empty(int syncs, int coop, int* out, int smem,
                            void* stream) {
  const void* fn = syncs == 0 ? (const void*)empty_kernel<0>
                 : syncs == 1 ? (const void*)empty_kernel<1>
                              : (const void*)empty_kernel<2>;
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  void* args[] = {&out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      coop ? cudaLaunchCooperativeKernel(fn, dim3(sms), dim3(512), args,
                                         smem, s)
           : cudaLaunchKernel(fn, dim3(sms), dim3(512), args, smem, s));
}
'''


def _stamped_source() -> str:
    """csrc/groupnorm.cu with the forward kernel's six stamps; raises if
    the source no longer has the places they go."""
    src = (ROOT / "sdxl_training_improvements_tpu_torch/csrc/groupnorm.cu"
           ).read_text()
    src = src.replace("namespace cg = cooperative_groups;\n", STAMP, 1)
    start = src.index("gn_silu_fwd_kernel(const T* __restrict__ x")
    end = src.rindex("\n}\n", start, src.index("gn_silu_bwd_kernel(const"))
    body = src[start:end]
    for anchor, stamped in (
            ("  Ring ring(smem, full);\n",
             "  Ring ring(smem, full);\n  stamp(0);\n"),
            ("    if (ln.active) {\n#pragma unroll\n      for (int e = 0; "
             "e < kVec; ++e) {\n        red[",
             "    stamp(1);\n    if (ln.active) {\n#pragma unroll\n      "
             "for (int e = 0; e < kVec; ++e) {\n        red["),
            ("  cg::this_grid().sync();\n",
             "  stamp(2);\n  cg::this_grid().sync();\n  stamp(3);\n"),
            ("    __syncthreads();\n    float mu[kVec], a[kVec], s[kVec];",
             "    __syncthreads();\n    stamp(4);\n    float mu[kVec], "
             "a[kVec], s[kVec];")):
        if anchor not in body:
            raise RuntimeError(f"stamp anchor not found: {anchor!r}")
        body = body.replace(anchor, stamped, 1)
    body += "\n  __syncthreads();\n  stamp(5);"
    return src[:start] + body + src[end:]


def _build_lib(name: str, source: str, include: Path) -> ctypes.CDLL:
    from sdxl_training_improvements_tpu_torch.ops import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / f"{name}.cu"
    lib = _build.BUILD_DIR / f"lib{name}.so"
    cu.write_text(source)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                    str(include), "-o", str(lib), str(cu)], check=True)
    return ctypes.CDLL(str(lib))


def _device_us(fn, iters: int = 20) -> float:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total
               for e in prof.key_averages()) / iters


def phases() -> None:
    from sdxl_training_improvements_tpu_torch.ops import _build
    from sdxl_training_improvements_tpu_torch.ops import groupnorm as G
    lib = _build_lib("gn_silu_stamped", _stamped_source(), _build.CSRC)
    lib.set_times.argtypes = [ctypes.c_void_p]
    times = torch.zeros(4096 * 8, dtype=torch.int64, device="cuda")
    if lib.set_times(times.data_ptr()) != 0:
        raise RuntimeError("set_times failed")
    # the wrapper's own argument setup, on the stamped library
    build_load, library = _build.load, G._library
    _build.load = lambda name: lib
    G._library = functools.lru_cache(maxsize=None)(library.__wrapped__)
    G._library()
    _build.load = build_load
    try:
        for shape in SHAPES:
            x = torch.randn(shape, device="cuda").bfloat16()
            w = torch.ones(shape[2], device="cuda")
            bias = torch.zeros_like(w)
            for _ in range(5):
                G.gn_silu_fwd_cuda(x, w, bias, 32, 1e-5)
            torch.cuda.synchronize()
            times.zero_()
            G.gn_silu_fwd_cuda(x, w, bias, 32, 1e-5)
            torch.cuda.synchronize()
            t = times.view(-1, 8)[:, :len(POINTS)].double()
            t = t[t[:, 0] > 0]
            rel = ((t - t[:, 0].min()) / 1e3).mean(0).tolist()
            print(f"{list(shape)} bf16, {len(t)} blocks, us after the first "
                  "block start (mean over blocks): "
                  + ", ".join(f"{p} {v:.2f}" for p, v in zip(POINTS, rel)),
                  flush=True)
    finally:
        G._library = library


def empty_kernels() -> None:
    from sdxl_training_improvements_tpu_torch.ops import _build
    lib = _build_lib("coop_empty", EMPTY, _build.CSRC)
    lib.launch_empty.argtypes = [ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p]
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for syncs, coop, what in ((0, 0, "plain launch"),
                              (0, 1, "cooperative launch"),
                              (1, 1, "cooperative, one grid barrier"),
                              (2, 1, "cooperative, two grid barriers")):
        def call():
            rc = lib.launch_empty(syncs, coop, out.data_ptr(), 192 * 1024,
                                  stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: cudaError_t {rc}")
        print(f"empty kernel, {what}: {_device_us(call):.2f} us of device "
              "time", flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    phases()
    empty_kernels()
