// Flash attention in exact fp32 for Hopper (sm_90a): the forward, dq and
// dk/dv of an fp32 UNet (training.mixed_precision = "no").
//
// Replaces the Pallas kernels `_fwd_kernel`, `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` of sdxl_training_improvements_tpu/ops/flash_attention.py
// for fp32 inputs, where they multiply in fp32 (`preferred_element_type`
// with fp32 operands).  wgmma has no fp32 operands, and its TF32 form keeps
// 10 mantissa bits, so every product here is an FFMA on the fp32 units.
//
// Bound: 4*S*T*D flops (forward), 6*S*T*D (dq) and 8*S*T*D (dk/dv) over
// the card's 67 TFLOP/s of fp32 outside the tensor cores; at SDXL's D = 64
// the operations are the limit (1.28 ms for the forward at B2 S=T=4096 H10).
//
// Design, simple and right first:
//
// * one block of 256 threads per (64-row tile of its own rows, batch*head):
//   q rows for the forward and dq, k rows for dk/dv; a loop over the other
//   side's 64-row tiles, as the Pallas kernels loop;
// * every tile is staged in shared memory as fp32 rows padded to D + 4
//   floats, so the 16-byte row reads of a quarter-warp fall in distinct
//   banks; rows beyond S or T are zeros;
// * thread (ty, tx) of a 16 x 16 grid computes the 4 x 4 scores of own
//   rows 4 ty + i and streamed rows tx + 16 j, FFMA over the head dim in
//   order; the 16 threads sharing own rows form a half-warp and reduce a
//   row by shuffles;
// * P (or dS) goes through a shared [64][68] tile to the second product,
//   where the thread owns 4 rows and D / 16 adjacent columns of the
//   64 x D accumulator, summed over the streamed rows in order;
// * the online softmax (forward) and P = exp(q k^T * scale - lse)
//   (backward) use the accurate expf; lse is [B, H, S] fp32, as the 16-bit
//   kernels write it;
// * no atomics: every sum runs in a fixed order, so two launches give
//   bit-equal results.
//
// Inputs are read through (batch, seq, head) element strides with a unit
// head-dim stride; outputs are written through their own strides.
//
// C interface for ctypes; each launcher returns the cudaError_t of its
// launch.

#include "hopper.cuh"

namespace {

constexpr int kRows = 64;      // rows of every tile
// a 16 x 16 grid.  Launch bounds: the forward asks for two blocks an SM
// (128 registers, spill-free at every head dim); dq and dk/dv for one
// (held to two, or left to ptxas's occupancy heuristics, they are cut to
// 128 registers and spill at some head dims)
constexpr int kThreads = 256;
constexpr int kPStride = kRows + 4;  // row stride of the P / dS tiles
constexpr int kSmemLimit = 232448;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

struct Strides {  // (batch, seq, head) element strides
  int64_t s[7][3];
};

// One head of a [B, N, H, D] tensor: its first row and its row stride.
template <typename T>
struct Head {
  T* p;
  int64_t row;
  __device__ __forceinline__ Head(T* base, const Strides& st, int i, int b,
                                  int h)
      : p(base + b * st.s[i][0] + h * st.s[i][2]), row(st.s[i][1]) {}
};

template <int D>
struct Cfg {
  static constexpr int kStride = D + 4;  // floats per staged row
  static constexpr int kTile = kRows * kStride;
  static constexpr int kP = kRows * kPStride;
  static constexpr int kW = D / 16;  // accumulator columns per thread
  static constexpr int kFwdSmem = (3 * kTile + kP) * 4;
  static constexpr int kDqSmem = (4 * kTile + kP) * 4;
  static constexpr int kDkvSmem = (4 * kTile + 2 * kP + 2 * kRows) * 4;
  static_assert(kDkvSmem <= kSmemLimit, "tiles exceed shared memory");
};

// Stage rows [r0, r0 + 64) of one head (rows >= n as zeros) at `dst`.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t row_stride, int r0, int n) {
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r * Cfg<D>::kStride + c] =
        r0 + r < n ? src[static_cast<int64_t>(r0 + r) * row_stride + c] : 0.f;
  }
}

// s[i][j] = sum_d A[4 ty + i][d] * B[tx + 16 j][d], d in order.
template <int D>
__device__ __forceinline__ void scores(float (&s)[4][4], const float* A,
                                       const float* B, int ty, int tx) {
  constexpr int P = Cfg<D>::kStride;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(A + (4 * ty + i) * P + d);
      b[i] = *reinterpret_cast<const float4*>(B + (tx + 16 * i) * P + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
    }
  }
}

// b = p[0, W), in 16-byte (or 8-byte) loads: p is aligned to W floats.
template <int W>
__device__ __forceinline__ void load_row(float (&b)[W], const float* p) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int c = 0; c < W; c += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + c);
      b[c] = t.x;
      b[c + 1] = t.y;
      b[c + 2] = t.z;
      b[c + 3] = t.w;
    }
  } else if constexpr (W == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    b[0] = t.x;
    b[1] = t.y;
  } else {
    b[0] = p[0];
  }
}

// acc[i][c] += sum_k X[4 ty + i][k] * B[k][tx * W + c] over the 64 rows of
// a staged tile B, k in order; X a [64][68] tile.
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[4][Cfg<D>::kW],
                                           const float* X, const float* B,
                                           int ty, int tx) {
  constexpr int P = Cfg<D>::kStride;
  constexpr int W = Cfg<D>::kW;
#pragma unroll 2
  for (int k = 0; k < kRows; k += 4) {
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = *reinterpret_cast<const float4*>(X + (4 * ty + i) * kPStride + k);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float b[W];
      load_row<W>(b, B + (k + kk) * P + tx * W);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xi = kk == 0 ? x[i].x : kk == 1 ? x[i].y
                         : kk == 2 ? x[i].z : x[i].w;
#pragma unroll
        for (int c = 0; c < W; ++c) acc[i][c] = fmaf(xi, b[c], acc[i][c]);
      }
    }
  }
}

// Max and sum over the 16 threads of a half-warp (the tx bits of the lane).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, o));
  }
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffff, x, o);
  return x;
}

// Store the thread's 4 rows of a 64 x D accumulator (rows >= n skipped),
// scaled per row by `mul`.
template <int D>
__device__ __forceinline__ void store_rows(float* dst, int64_t row_stride,
                                           const float (&acc)[4][Cfg<D>::kW],
                                           const float (&mul)[4], int r0,
                                           int n, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r < n) {
#pragma unroll
      for (int c = 0; c < Cfg<D>::kW; ++c) {
        dst[static_cast<int64_t>(r) * row_stride + tx * Cfg<D>::kW + c] =
            acc[i][c] * mul[i];
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_f32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int S, int T,
                     Strides st, float scale) {
  using C = Cfg<D>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + C::kTile;
  float* vs = ks + C::kTile;
  float* ps = vs + C::kTile;
  const int m0 = blockIdx.x * kRows;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const Head<const float> qh(q, st, 0, b, h), kh(k, st, 1, b, h),
      vh(v, st, 2, b, h);
  const Head<float> oh(o, st, 3, b, h);

  load_tile<D>(qs, qh.p, qh.row, m0, S);
  float m[4], l[4], acc[4][C::kW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -inf();
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::kW; ++c) acc[i][c] = 0.f;
  }
  const int n_tiles = (T + kRows - 1) / kRows;
  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * kRows;
    __syncthreads();  // the last tile's K, V and P are no longer read
    load_tile<D>(ks, kh.p, kh.row, n0, T);
    load_tile<D>(vs, vh.p, vh.row, n0, T);
    __syncthreads();
    float s[4][4];
    scores<D>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[i][jj] = n0 + tx + 16 * jj < T ? s[i][jj] * scale : -inf();
        mx = fmaxf(mx, s[i][jj]);
      }
      mx = row_max(mx);
      const float alpha = expf(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - mx);
        sum += p;
        ps[(4 * ty + i) * kPStride + tx + 16 * jj] = p;
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < C::kW; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    accumulate<D>(acc, ps, vs, ty, tx);
  }
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = row_sum(l[i]);
    inv[i] = 1.f / l[i];
  }
  store_rows<D>(oh.p, oh.row, acc, inv, m0, S, ty, tx);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + 4 * ty + i;
      if (r < S) lse[static_cast<int64_t>(bh) * S + r] = m[i] + logf(l[i]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_f32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int S, int T, Strides st, float scale) {
  using C = Cfg<D>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + C::kTile;
  float* ks = dos + C::kTile;
  float* vs = ks + C::kTile;
  float* dss = vs + C::kTile;
  const int m0 = blockIdx.x * kRows;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const Head<const float> qh(q, st, 0, b, h), kh(k, st, 1, b, h),
      vh(v, st, 2, b, h), doh(dO, st, 3, b, h);
  const Head<float> dqh(dq, st, 4, b, h);

  load_tile<D>(qs, qh.p, qh.row, m0, S);
  load_tile<D>(dos, doh.p, doh.row, m0, S);
  // rows >= S hold zeros in q and dO, so dS is 0 there for any lse
  float row_lse[4], row_delta[4], acc[4][C::kW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + 4 * ty + i;
    const int64_t at = static_cast<int64_t>(bh) * S + r;
    row_lse[i] = r < S ? lse[at] : 0.f;
    row_delta[i] = r < S ? delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < C::kW; ++c) acc[i][c] = 0.f;
  }
  const int n_tiles = (T + kRows - 1) / kRows;
  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * kRows;
    __syncthreads();
    load_tile<D>(ks, kh.p, kh.row, n0, T);
    load_tile<D>(vs, vh.p, vh.row, n0, T);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores<D>(s, qs, ks, ty, tx);    // q k^T
    scores<D>(dp, dos, vs, ty, tx);  // dO v^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p =
            n0 + tx + 16 * jj < T ? expf(s[i][jj] * scale - row_lse[i]) : 0.f;
        dss[(4 * ty + i) * kPStride + tx + 16 * jj] =
            p * (dp[i][jj] - row_delta[i]) * scale;
      }
    }
    __syncthreads();
    accumulate<D>(acc, dss, ks, ty, tx);  // dq += dS k
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<D>(dqh.p, dqh.row, acc, one, m0, S, ty, tx);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_f32_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dO,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int H,
                     int S, int T, Strides st, float scale) {
  using C = Cfg<D>;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + C::kTile;
  float* qs = vs + C::kTile;
  float* dos = qs + C::kTile;
  float* pts = dos + C::kTile;
  float* dsts = pts + C::kP;
  float* lses = dsts + C::kP;
  float* deltas = lses + kRows;
  const int n0 = blockIdx.x * kRows;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const Head<const float> qh(q, st, 0, b, h), kh(k, st, 1, b, h),
      vh(v, st, 2, b, h), doh(dO, st, 3, b, h);
  const Head<float> dkh(dk, st, 5, b, h), dvh(dv, st, 6, b, h);

  load_tile<D>(ks, kh.p, kh.row, n0, T);
  load_tile<D>(vs, vh.p, vh.row, n0, T);
  float dk_acc[4][C::kW], dv_acc[4][C::kW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < C::kW; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  }
  const int64_t rows = static_cast<int64_t>(bh) * S;
  const int n_tiles = (S + kRows - 1) / kRows;
  for (int j = 0; j < n_tiles; ++j) {
    const int m0 = j * kRows;
    __syncthreads();
    load_tile<D>(qs, qh.p, qh.row, m0, S);
    load_tile<D>(dos, doh.p, doh.row, m0, S);
    if (threadIdx.x < kRows) {  // q rows >= S: lse = +inf, so P = 0
      const int r = m0 + threadIdx.x;
      lses[threadIdx.x] = r < S ? lse[rows + r] : inf();
      deltas[threadIdx.x] = r < S ? delta[rows + r] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    scores<D>(s, ks, qs, ty, tx);    // S^T = k q^T
    scores<D>(dp, vs, dos, ty, tx);  // dP^T = v dO^T
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float l = lses[tx + 16 * jj];
      const float dl = deltas[tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[i][jj] * scale - l);
        pts[(4 * ty + i) * kPStride + tx + 16 * jj] = p;
        dsts[(4 * ty + i) * kPStride + tx + 16 * jj] =
            p * (dp[i][jj] - dl) * scale;
      }
    }
    __syncthreads();
    accumulate<D>(dv_acc, pts, dos, ty, tx);   // dv += P^T dO
    accumulate<D>(dk_acc, dsts, qs, ty, tx);   // dk += dS^T q
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<D>(dkh.p, dkh.row, dk_acc, one, n0, T, ty, tx);
  store_rows<D>(dvh.p, dvh.row, dv_acc, one, n0, T, ty, tx);
}

// strides: 7 (batch, seq, head) triples in the order q, k, v, dO (or o),
// dq, dk, dv; unused triples may hold anything.
Strides unpack(const int64_t* s, int n) {
  Strides st = {};
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < 3; ++j) st.s[i][j] = s[3 * i + j];
  }
  return st;
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int H, int S, int T, const Strides& st,
               float scale, cudaStream_t stream) {
  static uint64_t smem_allowed = 0;  // devices where the limit is raised
  cudaError_t e = hopper::allow_smem(flash_f32_fwd_kernel<D>,
                                     Cfg<D>::kFwdSmem, smem_allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((S + kRows - 1) / kRows, B * H);
  flash_f32_fwd_kernel<D><<<grid, kThreads, Cfg<D>::kFwdSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), H, S, T, st, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dO,
              const void* lse, const void* delta, void* dq, int B, int H,
              int S, int T, const Strides& st, float scale,
              cudaStream_t stream) {
  static uint64_t smem_allowed = 0;
  cudaError_t e = hopper::allow_smem(flash_f32_dq_kernel<D>, Cfg<D>::kDqSmem,
                                     smem_allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((S + kRows - 1) / kRows, B * H);
  flash_f32_dq_kernel<D><<<grid, kThreads, Cfg<D>::kDqSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), H, S, T, st, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int H, int S, int T, const Strides& st, float scale,
               cudaStream_t stream) {
  static uint64_t smem_allowed = 0;
  cudaError_t e = hopper::allow_smem(flash_f32_dkv_kernel<D>,
                                     Cfg<D>::kDkvSmem, smem_allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((T + kRows - 1) / kRows, B * H);
  flash_f32_dkv_kernel<D><<<grid, kThreads, Cfg<D>::kDkvSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), H, S, T, st, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) for q, k, v, o in turn.
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int S, int T,
                             int D, const int64_t* strides, float scale,
                             void* stream) {
  const Strides st = unpack(strides, 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_fwd<16>(q, k, v, o, lse, B, H, S, T, st, scale, s);
    case 32: return launch_fwd<32>(q, k, v, o, lse, B, H, S, T, st, scale, s);
    case 64: return launch_fwd<64>(q, k, v, o, lse, B, H, S, T, st, scale, s);
    case 128: return launch_fwd<128>(q, k, v, o, lse, B, H, S, T, st, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// strides: 21 element strides, (batch, seq, head) for q, k, v, dO, dq, dk,
// dv in turn.  lse and delta are [B*H, S] fp32.
extern "C" int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                const void* dO, const void* lse,
                                const void* delta, void* dq, int B, int H,
                                int S, int T, int D, const int64_t* strides,
                                float scale, void* stream) {
  const Strides st = unpack(strides, 7);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dq<16>(q, k, v, dO, lse, delta, dq, B, H, S, T, st, scale, s);
    case 32: return launch_dq<32>(q, k, v, dO, lse, delta, dq, B, H, S, T, st, scale, s);
    case 64: return launch_dq<64>(q, k, v, dO, lse, delta, dq, B, H, S, T, st, scale, s);
    case 128: return launch_dq<128>(q, k, v, dO, lse, delta, dq, B, H, S, T, st, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_bwd_dkv_f32(const void* q, const void* k,
                                 const void* v, const void* dO,
                                 const void* lse, const void* delta,
                                 void* dk, void* dv, int B, int H, int S,
                                 int T, int D, const int64_t* strides,
                                 float scale, void* stream) {
  const Strides st = unpack(strides, 7);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dkv<16>(q, k, v, dO, lse, delta, dk, dv, B, H, S, T, st, scale, s);
    case 32: return launch_dkv<32>(q, k, v, dO, lse, delta, dk, dv, B, H, S, T, st, scale, s);
    case 64: return launch_dkv<64>(q, k, v, dO, lse, delta, dk, dv, B, H, S, T, st, scale, s);
    case 128: return launch_dkv<128>(q, k, v, dO, lse, delta, dk, dv, B, H, S, T, st, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
