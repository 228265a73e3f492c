// Flash-attention backward for Hopper (sm_90a): bf16 q, k, v, dO in, bf16
// dq, dk, dv out, fp32 lse and Delta = rowsum(dO * O).
//
// Replaces the Pallas kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` of
// sdxl_training_improvements_tpu/ops/flash_attention.py (driven by `_bwd`),
// and keeps their split:
//
// * dq: one block per (batch*head, 64-row q tile), looping over 64-row kv
//   tiles: dq = sum_kv dS K, with dS = P * (dP - Delta) * scale,
//   P = exp(q k^T * scale - lse) and dP = dO v^T;
// * dkv: one block per (batch*head, 64-row kv tile), looping over 64-row q
//   tiles: dv = sum_q P^T dO, dk = sum_q dS^T q.
//
// Both recompute P from the forward's lse, so no [S, T] matrix is ever
// stored.  Each block has 4 warps; each warp owns 16 rows of its tile and
// keeps them as mma.sync A fragments in registers (q and dO rows in the dq
// kernel, k and v rows in the dkv kernel) for the whole loop.  The streamed
// tiles are staged in shared memory twice: row-major (the B operand of
// q k^T and dO v^T) and transposed (the B operand of dS k, P^T dO and
// dS^T q), so every B fragment is a pair of 32-bit shared loads.  Products
// run on mma.sync m16n8k16 (bf16 in, fp32 accumulate); P and dS are rounded
// to bf16 for their products, as the forward rounds P.
//
// Bound: at D = 64 the pair does 14*S*T*D flops (3 products in the dq
// kernel, 4 in the dkv kernel) for O((S + T) * D) bytes: compute-bound.
// This first version has no cp.async/TMA pipelining and no wgmma, and the
// transposed tiles are written with 2-byte shared stores.
//
// Masking from S and T, with no padded copies: kv rows >= T and q rows >= S
// load as zeros; P is 0 in kv columns >= T (dq kernel) and in q columns
// >= S (dkv kernel), as the Pallas kernels mask columns >= kv_valid and
// rows >= q_valid; rows beyond the sequence are never stored.
//
// C interface for ctypes; each launcher returns the cudaError_t of its
// launch.  Both take the same arguments; the outputs a kernel does not
// write may be null.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;  // q rows per tile
constexpr int kBlockN = 64;  // kv rows per tile
constexpr int kThreads = 128;
constexpr int kTStride = 64 + 8;  // padded row of a transposed tile
constexpr float kLog2e = 1.4426950408889634f;

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

// A fragments (16 rows x D) of rows r0 and r0 + 8 of a strided matrix.
template <int D>
__device__ __forceinline__ void load_rows(uint32_t (*f)[4],
                                          const __nv_bfloat16* base,
                                          int64_t row_stride, int r0, int n,
                                          int t) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    f[kk][0] = r0 < n ? load_pair(base + r0 * row_stride + c) : 0u;
    f[kk][1] = r1 < n ? load_pair(base + r1 * row_stride + c) : 0u;
    f[kk][2] = r0 < n ? load_pair(base + r0 * row_stride + c + 8) : 0u;
    f[kk][3] = r1 < n ? load_pair(base + r1 * row_stride + c + 8) : 0u;
  }
}

// Stage rows [r0, r0 + 64) of two strided [n, D] matrices in shared memory,
// row-major (stride D + 8) and transposed (stride kTStride); rows >= n are
// zeros.
template <int D>
__device__ __forceinline__ void stage_tiles(
    const __nv_bfloat16* a, int64_t a_stride, const __nv_bfloat16* b,
    int64_t b_stride, int r0, int n, __nv_bfloat16* a_s,
    __nv_bfloat16* at_s, __nv_bfloat16* b_s, __nv_bfloat16* bt_s, int tid) {
  constexpr int kRow = D + 8;
  constexpr int kChunks = D / 8;
  for (int i = tid; i < 64 * kChunks; i += kThreads) {
    const int row = i / kChunks;
    const int c8 = (i - row * kChunks) * 8;
    uint4 av = make_uint4(0u, 0u, 0u, 0u);
    uint4 bv = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + row < n) {
      av = *reinterpret_cast<const uint4*>(a + (r0 + row) * a_stride + c8);
      bv = *reinterpret_cast<const uint4*>(b + (r0 + row) * b_stride + c8);
    }
    *reinterpret_cast<uint4*>(a_s + row * kRow + c8) = av;
    *reinterpret_cast<uint4*>(b_s + row * kRow + c8) = bv;
    const __nv_bfloat16* ae = reinterpret_cast<const __nv_bfloat16*>(&av);
    const __nv_bfloat16* be = reinterpret_cast<const __nv_bfloat16*>(&bv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (at_s != nullptr) at_s[(c8 + j) * kTStride + row] = ae[j];
      if (bt_s != nullptr) bt_s[(c8 + j) * kTStride + row] = be[j];
    }
  }
}

// c[nt] = A (16 x D, fragments f) times the 64 rows of a row-major shared
// tile, transposed: a 16 x 64 block of A tile^T.
template <int D>
__device__ __forceinline__ void rows_times_tile_t(float (*c)[4],
                                                  uint32_t (*f)[4],
                                                  const __nv_bfloat16* tile,
                                                  int g, int t) {
  constexpr int kRow = D + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
    const __nv_bfloat16* r = tile + (nt * 8 + g) * kRow + 2 * t;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      mma_16816(c[nt], f[kk], load_pair(r + kk * 16),
                load_pair(r + kk * 16 + 8));
    }
  }
}

// acc (16 x D) += X (16 x 64, fp32 accumulators x, rounded to bf16) times
// the 64 x D matrix held transposed in shared memory (tile_t[d][row]).
template <int D>
__device__ __forceinline__ void acc_times_tile(float (*acc)[4],
                                               float (*x)[4],
                                               const __nv_bfloat16* tile_t,
                                               int g, int t) {
  // the accumulators of two adjacent 8-column tiles are exactly the A
  // fragment of one 16-deep k step
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const __nv_bfloat16* r = tile_t + (dt * 8 + g) * kTStride + kk * 16 + 2 * t;
      mma_16816(acc[dt], a, load_pair(r), load_pair(r + 8));
    }
  }
}

template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base,
                                           int64_t row_stride,
                                           float (*acc)[4], int r0,
                                           int n, int t) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (r0 < n) {
      *reinterpret_cast<uint32_t*>(base + r0 * row_stride + c) =
          pack_bf16(acc[dt][0], acc[dt][1]);
    }
    if (r1 < n) {
      *reinterpret_cast<uint32_t*>(base + r1 * row_stride + c) =
          pack_bf16(acc[dt][2], acc[dt][3]);
    }
  }
}

struct Strides {  // (batch, seq, head) element strides
  int64_t q[3], k[3], v[3], dO[3], dq[3], dk[3], dv[3];
};

template <int D>
constexpr int dq_smem_bytes() {  // K, V row-major; K transposed
  return (2 * kBlockN * (D + 8) + D * kTStride) * 2;
}

template <int D>
constexpr int dkv_smem_bytes() {  // Q, dO row-major and transposed; lse, Delta
  return (2 * kBlockM * (D + 8) + 2 * D * kTStride) * 2 + 2 * kBlockM * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int H, int S, int T,
                    Strides st, float scale) {
  constexpr int kRow = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = k_s + kBlockN * kRow;
  __nv_bfloat16* kt_s = v_s + kBlockN * kRow;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const __nv_bfloat16* kb = k + b * st.k[0] + h * st.k[2];
  const __nv_bfloat16* vb = v + b * st.v[0] + h * st.v[2];
  const int r0 = blockIdx.x * kBlockM + warp * 16 + g;
  const int r1 = r0 + 8;

  uint32_t qf[D / 16][4], df[D / 16][4];
  load_rows<D>(qf, q + b * st.q[0] + h * st.q[2], st.q[1], r0, S, t);
  load_rows<D>(df, dO + b * st.dO[0] + h * st.dO[2], st.dO[1], r0, S, t);
  const int64_t row_base = static_cast<int64_t>(bh) * S;
  const float lse0 = r0 < S ? lse[row_base + r0] * kLog2e : 0.f;
  const float lse1 = r1 < S ? lse[row_base + r1] * kLog2e : 0.f;
  const float dl0 = r0 < S ? delta[row_base + r0] : 0.f;
  const float dl1 = r1 < S ? delta[row_base + r1] : 0.f;
  const float scale_log2 = scale * kLog2e;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }

  for (int n0 = 0; n0 < T; n0 += kBlockN) {
    __syncthreads();  // the previous tiles are no longer read
    stage_tiles<D>(kb, st.k[1], vb, st.v[1], n0, T, k_s, kt_s, v_s, nullptr,
                   tid);
    __syncthreads();

    float s[8][4], dp[8][4];
    rows_times_tile_t<D>(s, qf, k_s, g, t);   // q k^T
    rows_times_tile_t<D>(dp, df, v_s, g, t);  // dO v^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = n0 + nt * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = col + (e & 1) < T;
        const float l = e < 2 ? lse0 : lse1;
        const float dl = e < 2 ? dl0 : dl1;
        const float p = valid ? exp2f(s[nt][e] * scale_log2 - l) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dl) * scale;  // dS
      }
    }
    acc_times_tile<D>(acc, s, kt_s, g, t);  // dq += dS k
  }
  store_rows<D>(dq + b * st.dq[0] + h * st.dq[2], st.dq[1], acc, r0, S, t);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dO,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int H, int S, int T,
                     Strides st, float scale) {
  constexpr int kRow = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* do_s = q_s + kBlockM * kRow;
  __nv_bfloat16* qt_s = do_s + kBlockM * kRow;
  __nv_bfloat16* dot_s = qt_s + D * kTStride;
  float* lse_s = reinterpret_cast<float*>(dot_s + D * kTStride);
  float* dl_s = lse_s + kBlockM;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const __nv_bfloat16* qb = q + b * st.q[0] + h * st.q[2];
  const __nv_bfloat16* dob = dO + b * st.dO[0] + h * st.dO[2];
  const int c0 = blockIdx.x * kBlockN + warp * 16 + g;  // kv rows

  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_rows<D>(kf, k + b * st.k[0] + h * st.k[2], st.k[1], c0, T, t);
  load_rows<D>(vf, v + b * st.v[0] + h * st.v[2], st.v[1], c0, T, t);
  const int64_t row_base = static_cast<int64_t>(bh) * S;
  const float scale_log2 = scale * kLog2e;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }

  for (int m0 = 0; m0 < S; m0 += kBlockM) {
    __syncthreads();  // the previous tiles are no longer read
    stage_tiles<D>(qb, st.q[1], dob, st.dO[1], m0, S, q_s, qt_s, do_s,
                   dot_s, tid);
    for (int i = tid; i < kBlockM; i += kThreads) {
      const bool in = m0 + i < S;
      lse_s[i] = in ? lse[row_base + m0 + i] * kLog2e : 0.f;
      dl_s[i] = in ? delta[row_base + m0 + i] : 0.f;
    }
    __syncthreads();

    float p[8][4], ds[8][4];
    rows_times_tile_t<D>(p, kf, q_s, g, t);    // k q^T
    rows_times_tile_t<D>(ds, vf, do_s, g, t);  // v dO^T = dP^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + 2 * t + (e & 1);
        const float pv = m0 + qi < S
                             ? exp2f(p[nt][e] * scale_log2 - lse_s[qi])
                             : 0.f;
        p[nt][e] = pv;
        ds[nt][e] = pv * (ds[nt][e] - dl_s[qi]) * scale;
      }
    }
    acc_times_tile<D>(dv_acc, p, dot_s, g, t);  // dv += P^T dO
    acc_times_tile<D>(dk_acc, ds, qt_s, g, t);  // dk += dS^T q
  }
  store_rows<D>(dk + b * st.dk[0] + h * st.dk[2], st.dk[1], dk_acc, c0, T,
                t);
  store_rows<D>(dv + b * st.dv[0] + h * st.dv[2], st.dv[1], dv_acc, c0, T,
                t);
}

Strides unpack(const int64_t* s) {
  Strides st;
  int64_t* dst[7] = {st.q, st.k, st.v, st.dO, st.dq, st.dk, st.dv};
  for (int i = 0; i < 7; ++i) {
    for (int j = 0; j < 3; ++j) dst[i][j] = s[3 * i + j];
  }
  return st;
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dO,
              const void* lse, const void* delta, void* dq, int B, int H,
              int S, int T, const Strides& st, float scale,
              cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((S + kBlockM - 1) / kBlockM, B * H);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dO), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), H,
      S, T, st, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int H, int S, int T, const Strides& st, float scale,
               cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((T + kBlockN - 1) / kBlockN, B * H);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dO), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, S, T, st, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 21 element strides, (batch, seq, head) for q, k, v, dO, dq, dk,
// dv in turn.  lse and delta are [B*H, S] fp32.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dO, const void* lse,
                                 const void* delta, void* dq, void* dk,
                                 void* dv, int B, int H, int S, int T, int D,
                                 const int64_t* strides, float scale,
                                 void* stream) {
  (void)dk;
  (void)dv;
  const Strides st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dq<16>(q, k, v, dO, lse, delta, dq, B, H, S, T, st, scale, s);
    case 32: return launch_dq<32>(q, k, v, dO, lse, delta, dq, B, H, S, T, st, scale, s);
    case 64: return launch_dq<64>(q, k, v, dO, lse, delta, dq, B, H, S, T, st, scale, s);
    case 128: return launch_dq<128>(q, k, v, dO, lse, delta, dq, B, H, S, T, st, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k,
                                  const void* v, const void* dO,
                                  const void* lse, const void* delta,
                                  void* dq, void* dk, void* dv, int B, int H,
                                  int S, int T, int D, const int64_t* strides,
                                  float scale, void* stream) {
  (void)dq;
  const Strides st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dkv<16>(q, k, v, dO, lse, delta, dk, dv, B, H, S, T, st, scale, s);
    case 32: return launch_dkv<32>(q, k, v, dO, lse, delta, dk, dv, B, H, S, T, st, scale, s);
    case 64: return launch_dkv<64>(q, k, v, dO, lse, delta, dk, dv, B, H, S, T, st, scale, s);
    case 128: return launch_dkv<128>(q, k, v, dO, lse, delta, dk, dv, B, H, S, T, st, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
