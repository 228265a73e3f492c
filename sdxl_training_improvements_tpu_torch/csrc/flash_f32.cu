// Flash-attention forward in exact fp32 for Hopper (sm_90a): the forward of
// an fp32 UNet (training.mixed_precision = "no").  Its backward, dq and
// dk/dv, is flash_bwd_f32.cu (TF32 wgmma on split operands).
//
// Replaces the Pallas kernel `_fwd_kernel` of
// sdxl_training_improvements_tpu/ops/flash_attention.py for fp32 inputs,
// where it multiplies in fp32 (`preferred_element_type` with fp32
// operands).  Every product here is an FFMA on the fp32 units.
//
// Bound: 4*S*T*D flops over the card's 67 TFLOP/s of fp32 outside the
// tensor cores (1.28 ms at B2 S=T=4096 H10); at the 165 TFLOP/s of
// split-TF32 products the backward runs at, 0.52 ms.
//
// Design, simple and right first:
//
// * one block of 256 threads per (64-row q tile, batch*head), a loop over
//   the 64-row kv tiles, as the Pallas kernel loops;
// * every tile is staged in shared memory as fp32 rows padded to D + 4
//   floats, so the 16-byte row reads of a quarter-warp fall in distinct
//   banks; rows beyond S or T are zeros;
// * thread (ty, tx) of a 16 x 16 grid computes the 4 x 4 scores of q
//   rows 4 ty + i and kv rows tx + 16 j, FFMA over the head dim in
//   order; the 16 threads sharing q rows form a half-warp and reduce a
//   row by shuffles;
// * P goes through a shared [64][68] tile to the P V product, where the
//   thread owns 4 rows and D / 16 adjacent columns of the 64 x D
//   accumulator, summed over the kv rows in order;
// * the online softmax uses the accurate expf; lse is [B, H, S] fp32, as
//   the 16-bit kernel writes it;
// * no atomics: every sum runs in a fixed order, so two launches give
//   bit-equal results.
//
// Inputs are read through (batch, seq, head) element strides with a unit
// head-dim stride; the output is written through its own strides.
//
// C interface for ctypes; the launcher returns the cudaError_t of its
// launch.

#include "hopper.cuh"

namespace {

constexpr int kRows = 64;      // rows of every tile
// a 16 x 16 grid; two blocks an SM (128 registers, spill-free at every
// head dim)
constexpr int kThreads = 256;
constexpr int kPStride = kRows + 4;  // row stride of the P tile
constexpr int kSmemLimit = 232448;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

struct Strides {  // (batch, seq, head) element strides of q, k, v, o
  int64_t s[4][3];
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
  static_assert(kFwdSmem <= kSmemLimit, "tiles exceed shared memory");
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

// strides: 4 (batch, seq, head) triples in the order q, k, v, o.
Strides unpack(const int64_t* s) {
  Strides st = {};
  for (int i = 0; i < 4; ++i) {
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

}  // namespace

// strides: 12 element strides, (batch, seq, head) for q, k, v, o in turn.
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int S, int T,
                             int D, const int64_t* strides, float scale,
                             void* stream) {
  const Strides st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_fwd<16>(q, k, v, o, lse, B, H, S, T, st, scale, s);
    case 32: return launch_fwd<32>(q, k, v, o, lse, B, H, S, T, st, scale, s);
    case 64: return launch_fwd<64>(q, k, v, o, lse, B, H, S, T, st, scale, s);
    case 128: return launch_fwd<128>(q, k, v, o, lse, B, H, S, T, st, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
