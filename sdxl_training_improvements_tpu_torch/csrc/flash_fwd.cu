// Flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out, fp32 lse.
//
// Replaces the Pallas kernel `_fwd_kernel` of
// sdxl_training_improvements_tpu/ops/flash_attention.py (driven by `_fwd`).
// It computes, per (batch, head), out = softmax(q k^T * scale) v without
// materialising the [S, T] score matrix, and the per-row logsumexp that a
// backward pass recomputes the probabilities from.
//
// Layout: one thread block of 4 warps per (batch*head, 64-row q tile).  Each
// warp owns 16 q rows, keeps them as mma.sync A fragments in registers for
// the whole kv loop, and walks 64-row K/V tiles staged in shared memory (V is
// stored transposed so its B fragments are 32-bit shared loads).  Products
// run on the tensor cores through mma.sync m16n8k16 (bf16 in, fp32
// accumulate); the softmax is online: a running max, a normaliser and an
// fp32 output accumulator rescaled per tile, as in the Pallas kernel.
// Bound: at SDXL's D = 64 the kernel does 4*S*T*D flops for 2*(S+T)*D*2
// bytes, so it is compute-bound; this first version has no cp.async/TMA
// pipelining and no wgmma, so it reaches a fraction of the tensor-core rate.
//
// The ragged kv edge (T = 77 text tokens) is masked here from T itself, so
// the wrapper pads nothing: rows >= T load as zeros and their logits are set
// to -1e30 before the max, as the Pallas kernel masks columns >= kv_valid.
// Inputs are addressed through (batch, seq, head) strides with a unit head
// dim stride, so the projections' [B, S, H*D] outputs are read in place.
//
// C interface for ctypes; the launcher returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;
constexpr int kBlockN = 64;
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffff, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffff, x, 1);
  return x + __shfl_xor_sync(0xffffffff, x, 2);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int H, int S, int T,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh,
                 int64_t k_sb, int64_t k_st, int64_t k_sh,
                 int64_t v_sb, int64_t v_st, int64_t v_sh,
                 int64_t o_sb, int64_t o_ss, int64_t o_sh,
                 float scale_log2) {
  constexpr int kKStride = D + 8;        // padded row of the K tile
  constexpr int kVStride = kBlockN + 8;  // padded row of the transposed V tile
  constexpr int kChunks = D / 8;         // 16-byte chunks per K/V row
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockN * kKStride];
  __shared__ __align__(16) __nv_bfloat16 vt_s[D * kVStride];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  // This thread's two q rows: r0 and r0 + 8.
  const int r0 = blockIdx.x * kBlockM + warp * 16 + g;
  const int r1 = r0 + 8;

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = r0 < S ? load_pair(qb + r0 * q_ss + c) : 0u;
    qf[kk][1] = r1 < S ? load_pair(qb + r1 * q_ss + c) : 0u;
    qf[kk][2] = r0 < S ? load_pair(qb + r0 * q_ss + c + 8) : 0u;
    qf[kk][3] = r1 < S ? load_pair(qb + r1 * q_ss + c + 8) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
  float m0 = kNegInf, m1 = kNegInf;  // running max, log2 units
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the normaliser

  for (int n0 = 0; n0 < T; n0 += kBlockN) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < kBlockN * kChunks; i += kThreads) {
      const int row = i / kChunks;
      const int c8 = (i - row * kChunks) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + row < T) {
        kv = *reinterpret_cast<const uint4*>(kb + (n0 + row) * k_st + c8);
        vv = *reinterpret_cast<const uint4*>(vb + (n0 + row) * v_st + c8);
      }
      *reinterpret_cast<uint4*>(k_s + row * kKStride + c8) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt_s[(c8 + j) * kVStride + row] = ve[j];
    }
    __syncthreads();

    // s = q k^T for this warp's 16 rows x 64 kv columns.
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = k_s + (nt * 8 + g) * kKStride + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_16816(s[nt], qf[kk], load_pair(kr + kk * 16),
                  load_pair(kr + kk * 16 + 8));
      }
    }

    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      const int col = n0 + nt * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = col + (e & 1) < T;
        s[nt][e] = valid ? s[nt][e] * scale_log2 : kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = exp2f(m0 - mn0);
    const float alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn0);
      s[nt][1] = exp2f(s[nt][1] - mn0);
      s[nt][2] = exp2f(s[nt][2] - mn1);
      s[nt][3] = exp2f(s[nt][3] - mn1);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }

    // acc += p v: the s accumulators of two adjacent 8-column tiles are
    // exactly the A fragment of one 16-deep k step.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vr =
            vt_s + (dt * 8 + g) * kVStride + kk * 16 + 2 * t;
        mma_16816(acc[dt], pf, load_pair(vr), load_pair(vr + 8));
      }
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (r0 < S) {
      *reinterpret_cast<uint32_t*>(ob + r0 * o_ss + c) =
          pack_bf16(acc[dt][0] * inv0, acc[dt][1] * inv0);
    }
    if (r1 < S) {
      *reinterpret_cast<uint32_t*>(ob + r1 * o_ss + c) =
          pack_bf16(acc[dt][2] * inv1, acc[dt][3] * inv1);
    }
  }
  if (t == 0) {
    const float ln2 = 0.6931471805599453f;
    if (r0 < S) lse[(int64_t)bh * S + r0] = (m0 + log2f(l0)) * ln2;
    if (r1 < S) lse[(int64_t)bh * S + r1] = (m1 + log2f(l1)) * ln2;
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, void* o, void* lse,
            int B, int H, int S, int T, const int64_t* st, float scale_log2,
            cudaStream_t stream) {
  dim3 grid((S + kBlockM - 1) / kBlockM, B * H);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, S, T, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale_log2);
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) for q, k, v, o in turn.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int H, int S, int T,
                              int D, const int64_t* strides, float scale,
                              void* stream) {
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: launch<16>(q, k, v, o, lse, B, H, S, T, strides, scale_log2, st); break;
    case 32: launch<32>(q, k, v, o, lse, B, H, S, T, strides, scale_log2, st); break;
    case 64: launch<64>(q, k, v, o, lse, B, H, S, T, strides, scale_log2, st); break;
    case 128: launch<128>(q, k, v, o, lse, B, H, S, T, strides, scale_log2, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
