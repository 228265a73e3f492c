// Flash-attention backward for Hopper (sm_90a): bf16 or fp16 q, k, v, dO
// in, dq, dk, dv out in the same type, fp32 lse and Delta = rowsum(dO * O).
//
// Replaces the Pallas kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` of
// sdxl_training_improvements_tpu/ops/flash_attention.py (driven by `_bwd`),
// and keeps their split:
//
// * dq: one block per (batch*head, 128-row q tile), looping over kv tiles:
//   dq = sum_kv dS K, with dS = P * (dP - Delta) * scale,
//   P = exp(q k^T * scale - lse) and dP = dO v^T;
// * dkv: one block per (batch*head, 128-row kv tile[, q split]), looping
//   over q tiles: dv = sum_q P^T dO, dk = sum_q dS^T q.
//
// Both recompute P from the forward's lse, so no [S, T] matrix is stored.
// Bound: 6*S*T*D flops (dq) and 8*S*T*D (dk/dv) for O((S + T) * D) bytes:
// at D = 64 the tensor cores are the limit (0.26 and 0.35 ms for B4 S=T=4096
// H10 at 989 TFLOP/s).  Both kernels take the warp-specialised Hopper shape
// (hopper.cuh for the building blocks):
//
// * three warpgroups per block: a producer that issues TMA and gives its
//   registers up (setmaxnreg), and two consumer warpgroups that each own 64
//   rows of the block's tile and keep their fp32 gradient accumulators in
//   registers for the whole loop;
// * the block's own rows (q and dO for dq, k and v for dk/dv) arrive once by
//   TMA; the other side's tiles (128 rows, 64 at D = 128) stream through a
//   3-stage ring of shared-memory buffers guarded by mbarriers;
// * the two score-shaped products (S = Q K^T and dP = dO V^T, or their
//   transposes S^T = K Q^T and dP^T = V dO^T) are SS wgmmas with K-major
//   operands; P and dS are formed in registers on the accumulator layout
//   and rounded to the input type, as the forward rounds P;
// * the gradient products (dq += dS K, dv += P^T dO, dk += dS^T Q) take P
//   or dS as the register A operand and read the streamed tile MN-major
//   (the trans-b flag) from the same TMA buffer, so no tile is transposed.
//
// dS in fp16: its range ends at 6e-8, and with no loss scale a small dO
// puts dS below it (the Pallas kernels keep dS in fp32).  So the fp16
// kernels form u * dS, u = 2^-floor(log2 max|dO|) (at least 1; max|dO| is
// read from the launcher's `dout_absmax`), and multiply the fp32
// accumulators of the dS products (dq, dk) by 1 / u before they are
// stored: u is a power of two, so no other rounding changes.  bf16 keeps
// fp32's range, and its kernels take u = 1 (`ds_unit`).
//
// Masking from S and T, with no padded copies: TMA fills rows >= S and
// >= T with zeros; the dq kernel sets P = 0 in kv columns >= T, the dk/dv
// kernel gives q rows >= S an lse of +inf (so P = 0), as the Pallas kernels
// mask columns >= kv_valid and rows >= q_valid; rows beyond the sequence
// are never stored.
//
// Small T (cross-attention, T = 77: one kv tile per head, too few blocks
// for 132 SMs): the wrapper splits the dk/dv q loop over `splits` blocks.
// Each writes fp32 partial dk and dv into scratch the wrapper allocates,
// and `dkv_reduce_kernel` sums them in split order and casts to the
// output type: no
// atomics, so the gradients are the same from run to run.
//
// The kernels are templates on the element type (hopper.cuh: Bf16, F16);
// the `_bf16` and `_f16` launchers run their two instantiations.
//
// C interface for ctypes; each launcher returns the cudaError_t of its
// launches (or hopper::kEncodeError + the CUresult of a tensor map it cannot
// build).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kOwn = 128;  // rows of the block's own tile, 64 per consumer
constexpr int kStages = 3;
constexpr int kThreads = 384;  // 2 consumer warpgroups + the producer's
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

template <int D>
struct Cfg {
  static constexpr int kCW = D < 64 ? D : 64;  // columns per swizzled chunk
  static constexpr int kChunks = D / kCW;
  static constexpr int kRow = 2 * kCW;          // bytes per chunk row
  // rows of a streamed tile: 128 where the consumers' four fp32 tiles (two
  // 64 x kStream scores, two 64 x D gradients) fit their 240 registers, 64
  // at D = 128 (128 would spill)
  static constexpr int kStream = D <= 64 ? 128 : 64;
  static constexpr int kOwnBytes = kOwn * D * 2;
  static constexpr int kStreamBytes = kStream * D * 2;
  // own tiles a, b | streamed tiles a[stages], b[stages] | lse, Delta
  // [stages][kStream] fp32 (dk/dv only) | barriers own_full, full[s],
  // empty[s]
  static constexpr int kRowsOffset =
      2 * kOwnBytes + 2 * kStages * kStreamBytes;
  static constexpr int kBarOffset = kRowsOffset + 2 * kStages * kStream * 4;
  static constexpr int kSmem = kBarOffset + 8 * (1 + 2 * kStages) + 1024;
};

struct Strides {  // (batch, seq, head) element strides
  int64_t q[3], k[3], v[3], dO[3], dq[3], dk[3], dv[3];
};

// Addresses of one block's shared memory, aligned to the 1024-byte swizzle
// atom, and its barriers initialised.
template <int D>
struct Smem {
  using C = Cfg<D>;
  unsigned char* generic;  // the aligned base as a generic pointer
  uint32_t base;

  __device__ __forceinline__ Smem(unsigned char* raw) {
    const uint32_t r = smem_u32(raw);
    base = (r + 1023) & ~1023u;
    generic = raw + (base - r);
    if (threadIdx.x == 0) {
      mbar_init(own_full(), 1);
      for (int i = 0; i < kStages; ++i) {
        mbar_init(full(i), 1);
        mbar_init(empty(i), 2 * 128);
      }
      fence_barrier_init();
    }
    __syncthreads();
  }
  __device__ __forceinline__ uint32_t own_a() const { return base; }
  __device__ __forceinline__ uint32_t own_b() const {
    return base + C::kOwnBytes;
  }
  __device__ __forceinline__ uint32_t stream_a(int st) const {
    return base + 2 * C::kOwnBytes + st * C::kStreamBytes;
  }
  __device__ __forceinline__ uint32_t stream_b(int st) const {
    return base + 2 * C::kOwnBytes + (kStages + st) * C::kStreamBytes;
  }
  __device__ __forceinline__ float* lse(int st) const {
    return reinterpret_cast<float*>(generic + C::kRowsOffset) +
           st * C::kStream;
  }
  __device__ __forceinline__ float* delta(int st) const {
    return lse(kStages) + st * C::kStream;
  }
  __device__ __forceinline__ uint32_t own_full() const {
    return base + C::kBarOffset;
  }
  __device__ __forceinline__ uint32_t full(int st) const {
    return own_full() + 8 * (1 + st);
  }
  __device__ __forceinline__ uint32_t empty(int st) const {
    return own_full() + 8 * (1 + kStages + st);
  }
};

// Load the block's own rows [r0, r0 + 128) of two tensors (one box of
// kOwn rows per chunk).
template <int D>
__device__ __forceinline__ void load_own(const Smem<D>& sm,
                                         const CUtensorMap* a,
                                         const CUtensorMap* b, int h, int r0,
                                         int bb) {
  using C = Cfg<D>;
  mbar_arrive_expect_tx(sm.own_full(), 2 * C::kOwnBytes);
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c) {
    tma_load_4d(sm.own_a() + c * kOwn * C::kRow, a, sm.own_full(),
                c * C::kCW, h, r0, bb);
    tma_load_4d(sm.own_b() + c * kOwn * C::kRow, b, sm.own_full(),
                c * C::kCW, h, r0, bb);
  }
}

// Load the streamed rows [r0, r0 + kStream) of two tensors into stage st.
template <int D>
__device__ __forceinline__ void load_stream(const Smem<D>& sm, int st,
                                            const CUtensorMap* a,
                                            const CUtensorMap* b, int h,
                                            int r0, int bb) {
  using C = Cfg<D>;
  mbar_arrive_expect_tx(sm.full(st), 2 * C::kStreamBytes);
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c) {
    tma_load_4d(sm.stream_a(st) + c * C::kStream * C::kRow, a, sm.full(st),
                c * C::kCW, h, r0, bb);
    tma_load_4d(sm.stream_b(st) + c * C::kStream * C::kRow, b, sm.full(st),
                c * C::kCW, h, r0, bb);
  }
}

// acc[64 x kStream] = A B^T over the head dim: A the consumer's 64 rows of an
// own tile, B a streamed tile, both K-major.
template <typename E, int D>
__device__ __forceinline__ void scores(float (&acc)[Cfg<D>::kStream / 2],
                                       uint32_t own, uint32_t stream) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk / (C::kCW / 16);
    const int off = (kk % (C::kCW / 16)) * 32;
    wgmma_ss<E, C::kStream>(
        acc, desc_k<C::kCW>(own + c * kOwn * C::kRow + off),
        desc_k<C::kCW>(stream + c * C::kStream * C::kRow + off), kk > 0);
  }
}

// acc[64 x D] += X B over kStream rows of B: X as A fragments, B the
// first kStream rows of a tile of ROWS rows, read MN-major.
template <typename E, int D, int ROWS>
__device__ __forceinline__ void accumulate(
    float (&acc)[Cfg<D>::kChunks][Cfg<D>::kCW / 2],
    const uint32_t (&x)[Cfg<D>::kStream / 16][4], uint32_t tile) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < C::kStream / 16; ++kk) {
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) {
      wgmma_rs<E, C::kCW>(acc[c], x[kk],
                       desc_mn<C::kCW>(tile + c * ROWS * C::kRow +
                                       kk * 16 * C::kRow));
    }
  }
}

// Store rows r0 and r0 + 8 (< n) of an accumulator [64 x D] as E.
template <typename E, int D>
__device__ __forceinline__ void store_rows(
    typename E::T* base, int64_t row_stride,
    const float (&acc)[Cfg<D>::kChunks][Cfg<D>::kCW / 2], int r0, int n,
    int t) {
  using C = Cfg<D>;
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c) {
#pragma unroll
    for (int j = 0; j < C::kCW / 8; ++j) {
      const int col = c * C::kCW + 8 * j + 2 * t;
      if (r0 < n) {
        *reinterpret_cast<uint32_t*>(base + r0 * row_stride + col) =
            E::pack(acc[c][4 * j], acc[c][4 * j + 1]);
      }
      if (r0 + 8 < n) {
        *reinterpret_cast<uint32_t*>(base + (r0 + 8) * row_stride + col) =
            E::pack(acc[c][4 * j + 2], acc[c][4 * j + 3]);
      }
    }
  }
}

// The same rows as fp32 into a dense [n, D] partial.
template <int D>
__device__ __forceinline__ void store_partial(
    float* base, const float (&acc)[Cfg<D>::kChunks][Cfg<D>::kCW / 2],
    int r0, int n, int t) {
  using C = Cfg<D>;
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c) {
#pragma unroll
    for (int j = 0; j < C::kCW / 8; ++j) {
      const int col = c * C::kCW + 8 * j + 2 * t;
      if (r0 < n) {
        *reinterpret_cast<float2*>(base + (int64_t)r0 * D + col) =
            make_float2(acc[c][4 * j], acc[c][4 * j + 1]);
      }
      if (r0 + 8 < n) {
        *reinterpret_cast<float2*>(base + (int64_t)(r0 + 8) * D + col) =
            make_float2(acc[c][4 * j + 2], acc[c][4 * j + 3]);
      }
    }
  }
}

template <int D>
__device__ __forceinline__ void scale_acc(
    float (&acc)[Cfg<D>::kChunks][Cfg<D>::kCW / 2], float f) {
#pragma unroll
  for (int c = 0; c < Cfg<D>::kChunks; ++c) {
#pragma unroll
    for (int i = 0; i < Cfg<D>::kCW / 2; ++i) acc[c][i] *= f;
  }
}

// The factor u of dS (see the note at the top): 1 but for fp16.
template <typename E>
__device__ __forceinline__ float ds_unit(const float* dout_absmax) {
  if constexpr (E::kNarrowRange) {
    const float m = *dout_absmax;
    if (m > 0.f && m < 1.f) return ldexpf(1.f, -ilogbf(m));
  }
  return 1.f;
}

template <int D>
__device__ __forceinline__ void zero(
    float (&acc)[Cfg<D>::kChunks][Cfg<D>::kCW / 2]) {
#pragma unroll
  for (int c = 0; c < Cfg<D>::kChunks; ++c) {
#pragma unroll
    for (int i = 0; i < Cfg<D>::kCW / 2; ++i) acc[c][i] = 0.f;
  }
}

template <typename E, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ dout_absmax,
                    typename E::T* __restrict__ dq, int H, int S, int T,
                    int64_t dq_sb, int64_t dq_ss, int64_t dq_sh,
                    float scale) {
  using C = Cfg<D>;
  constexpr int kStream = C::kStream;
  extern __shared__ unsigned char smem_raw[];
  const Smem<D> sm(smem_raw);
  const int m0 = blockIdx.x * kOwn;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int n_tiles = (T + kStream - 1) / kStream;

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer: own q, dO; streamed k, v
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      load_own<D>(sm, &q_map, &do_map, h, m0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        mbar_wait(sm.empty(st), ((j / kStages) & 1) ^ 1);
        load_stream<D>(sm, st, &k_map, &v_map, h, j * kStream, b);
      }
    }
  } else {  // consumers: warpgroup wg owns q rows [wg * 64, wg * 64 + 64)
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128;
    const int lane = tid & 31;
    const int t = lane & 3;
    const int r0 = m0 + wg * 64 + (tid >> 5) * 16 + (lane >> 2);
    const int r1 = r0 + 8;
    const int64_t rows = static_cast<int64_t>(bh) * S;
    // rows >= S hold zeros in q and dO, so dS is 0 there for any lse
    const float lse0 = r0 < S ? lse[rows + r0] * kLog2e : 0.f;
    const float lse1 = r1 < S ? lse[rows + r1] * kLog2e : 0.f;
    const float dl0 = r0 < S ? delta[rows + r0] : 0.f;
    const float dl1 = r1 < S ? delta[rows + r1] : 0.f;
    const float scale_log2 = scale * kLog2e;
    const float unit = ds_unit<E>(dout_absmax);
    const float ds_scale = scale * unit;

    float acc[C::kChunks][C::kCW / 2];
    zero<D>(acc);
    float s[kStream / 2], dp[kStream / 2];
    uint32_t ds[kStream / 16][4];
    const uint32_t q_wg = sm.own_a() + wg * 64 * C::kRow;
    const uint32_t do_wg = sm.own_b() + wg * 64 * C::kRow;

    mbar_wait(sm.own_full(), 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages;
      mbar_wait(sm.full(st), (j / kStages) & 1);
      wgmma_fence();
      scores<E, D>(s, q_wg, sm.stream_a(st));    // q k^T
      scores<E, D>(dp, do_wg, sm.stream_b(st));  // dO v^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(s);
      fence_operands(dp);
      // s[4 n + e]: row r0 (e < 2) or r1, kv column n0 + 8 n + 2 t + e % 2
      const int n0 = j * kStream;
#pragma unroll
      for (int n = 0; n < kStream / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = n0 + 8 * n + 2 * t + (e & 1) < T;
          const float l = e < 2 ? lse0 : lse1;
          const float dl = e < 2 ? dl0 : dl1;
          const float p = valid ? exp2f(s[4 * n + e] * scale_log2 - l) : 0.f;
          s[4 * n + e] = p * (dp[4 * n + e] - dl) * ds_scale;  // u dS
        }
      }
      acc_to_a<E, kStream>(s, ds);
      wgmma_fence();
      accumulate<E, D, kStream>(acc, ds, sm.stream_a(st));  // dq += dS k
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) fence_operands(acc[c]);
      mbar_arrive(sm.empty(st));
    }
    if constexpr (E::kNarrowRange) scale_acc<D>(acc, 1.f / unit);
    store_rows<E, D>(dq + b * dq_sb + h * dq_sh, dq_ss, acc, r0, S, t);
  }
}

template <typename E, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ dout_absmax,
                     typename E::T* __restrict__ dk,
                     typename E::T* __restrict__ dv,
                     float* __restrict__ dk_part, float* __restrict__ dv_part,
                     int H, int S, int T, int q_tiles_per_split, Strides st,
                     float scale) {
  using C = Cfg<D>;
  constexpr int kStream = C::kStream;
  extern __shared__ unsigned char smem_raw[];
  const Smem<D> sm(smem_raw);
  const int n0 = blockIdx.x * kOwn;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q_tiles = (S + kStream - 1) / kStream;
  const int first = blockIdx.z * q_tiles_per_split;
  const int n_tiles = min(q_tiles_per_split, q_tiles - first);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer warp: own k, v; streamed q, dO, lse, Delta
    setmaxnreg_dec<24>();
    if (threadIdx.x < 256 + 32) {
      const int lane = threadIdx.x & 31;
      const int64_t rows = static_cast<int64_t>(bh) * S;
      if (lane == 0) load_own<D>(sm, &k_map, &v_map, h, n0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const int m = (first + i) * kStream;
        mbar_wait(sm.empty(s), ((i / kStages) & 1) ^ 1);
        // q rows >= S: lse = +inf, so P = exp2(-inf) = 0 there
        for (int r = lane; r < kStream; r += 32) {
          const bool in = m + r < S;
          sm.lse(s)[r] = in ? lse[rows + m + r] * kLog2e : inf();
          sm.delta(s)[r] = in ? delta[rows + m + r] : 0.f;
        }
        __syncwarp();
        if (lane == 0) load_stream<D>(sm, s, &q_map, &do_map, h, m, b);
      }
    }
  } else {  // consumers: warpgroup wg owns kv rows [wg * 64, wg * 64 + 64)
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128;
    const int lane = tid & 31;
    const int t = lane & 3;
    const float scale_log2 = scale * kLog2e;
    const float unit = ds_unit<E>(dout_absmax);
    const float ds_scale = scale * unit;

    float dk_acc[C::kChunks][C::kCW / 2], dv_acc[C::kChunks][C::kCW / 2];
    zero<D>(dk_acc);
    zero<D>(dv_acc);
    float s[kStream / 2], dp[kStream / 2];
    uint32_t pa[kStream / 16][4], da[kStream / 16][4];
    const uint32_t k_wg = sm.own_a() + wg * 64 * C::kRow;
    const uint32_t v_wg = sm.own_b() + wg * 64 * C::kRow;

    mbar_wait(sm.own_full(), 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s_ = i % kStages;
      mbar_wait(sm.full(s_), (i / kStages) & 1);
      wgmma_fence();
      scores<E, D>(s, k_wg, sm.stream_a(s_));    // S^T = k q^T
      scores<E, D>(dp, v_wg, sm.stream_b(s_));   // dP^T = v dO^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(s);
      fence_operands(dp);
      // s[4 n + e]: kv row r0 (e < 2) or r0 + 8, q column 8 n + 2 t + e % 2
      const float* ls = sm.lse(s_);
      const float* dls = sm.delta(s_);
#pragma unroll
      for (int n = 0; n < kStream / 8; ++n) {
        const float2 l = *reinterpret_cast<const float2*>(ls + 8 * n + 2 * t);
        const float2 dl =
            *reinterpret_cast<const float2*>(dls + 8 * n + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              exp2f(s[4 * n + e] * scale_log2 - ((e & 1) ? l.y : l.x));
          s[4 * n + e] = p;
          dp[4 * n + e] =
              p * (dp[4 * n + e] - ((e & 1) ? dl.y : dl.x)) * ds_scale;
        }
      }
      acc_to_a<E, kStream>(s, pa);
      acc_to_a<E, kStream>(dp, da);
      wgmma_fence();
      accumulate<E, D, kStream>(dv_acc, pa, sm.stream_b(s_));  // dv += P^T dO
      accumulate<E, D, kStream>(dk_acc, da, sm.stream_a(s_));  // dk += dS^T q
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) {
        fence_operands(dk_acc[c]);
        fence_operands(dv_acc[c]);
      }
      mbar_arrive(sm.empty(s_));
    }
    const int r0 = n0 + wg * 64 + (tid >> 5) * 16 + (lane >> 2);
    if constexpr (E::kNarrowRange) scale_acc<D>(dk_acc, 1.f / unit);
    if (dk_part != nullptr) {
      const int64_t part =
          (static_cast<int64_t>(blockIdx.z) * gridDim.y + bh) * T * D;
      store_partial<D>(dk_part + part, dk_acc, r0, T, t);
      store_partial<D>(dv_part + part, dv_acc, r0, T, t);
    } else {
      store_rows<E, D>(dk + b * st.dk[0] + h * st.dk[2], st.dk[1], dk_acc, r0,
                    T, t);
      store_rows<E, D>(dv + b * st.dv[0] + h * st.dv[2], st.dv[1], dv_acc, r0,
                    T, t);
    }
  }
}

// dk, dv = sum over splits of the fp32 partials [splits, B*H, T, D], in
// split order, rounded to E; one thread per pair of columns.
template <typename E>
__global__ void dkv_reduce_kernel(const float* __restrict__ dk_part,
                                  const float* __restrict__ dv_part,
                                  typename E::T* __restrict__ dk,
                                  typename E::T* __restrict__ dv, int splits,
                                  int H, int T, int D, int64_t pairs,
                                  Strides st) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= pairs) return;
  const int64_t e = 2 * i;
  const int d = static_cast<int>(e % D);
  const int64_t row = e / D;
  const int t = static_cast<int>(row % T);
  const int bh = static_cast<int>(row / T);
  const int b = bh / H;
  const int h = bh - b * H;
  float2 k2 = make_float2(0.f, 0.f), v2 = make_float2(0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float2 pk = reinterpret_cast<const float2*>(dk_part)[s * pairs + i];
    const float2 pv = reinterpret_cast<const float2*>(dv_part)[s * pairs + i];
    k2.x += pk.x;
    k2.y += pk.y;
    v2.x += pv.x;
    v2.y += pv.y;
  }
  *reinterpret_cast<uint32_t*>(dk + b * st.dk[0] + t * st.dk[1] +
                               h * st.dk[2] + d) = E::pack(k2.x, k2.y);
  *reinterpret_cast<uint32_t*>(dv + b * st.dv[0] + t * st.dv[1] +
                               h * st.dv[2] + d) = E::pack(v2.x, v2.y);
}

Strides unpack(const int64_t* s) {
  Strides st;
  int64_t* dst[7] = {st.q, st.k, st.v, st.dO, st.dq, st.dk, st.dv};
  for (int i = 0; i < 7; ++i) {
    for (int j = 0; j < 3; ++j) dst[i][j] = s[3 * i + j];
  }
  return st;
}

// Tensor maps of q, dO (seq S) and k, v (seq T) with boxes of `q_rows` and
// `kv_rows` rows.
template <typename E, int D>
int make_maps(CUtensorMap* q_map, CUtensorMap* do_map, CUtensorMap* k_map,
              CUtensorMap* v_map, const void* q, const void* k, const void* v,
              const void* dO, int B, int H, int S, int T, const Strides& st,
              int q_rows, int kv_rows) {
  constexpr int kCW = Cfg<D>::kCW;
  int rc = make_map<E, kCW>(q_map, q, B, S, H, D, st.q[0], st.q[1], st.q[2],
                         q_rows);
  if (rc == 0) {
    rc = make_map<E, kCW>(do_map, dO, B, S, H, D, st.dO[0], st.dO[1], st.dO[2],
                       q_rows);
  }
  if (rc == 0) {
    rc = make_map<E, kCW>(k_map, k, B, T, H, D, st.k[0], st.k[1], st.k[2],
                       kv_rows);
  }
  if (rc == 0) {
    rc = make_map<E, kCW>(v_map, v, B, T, H, D, st.v[0], st.v[1], st.v[2],
                       kv_rows);
  }
  return rc;
}

template <typename E, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dO,
              const void* lse, const void* delta, const void* dout_absmax,
              void* dq, int B, int H,
              int S, int T, const Strides& st, float scale,
              cudaStream_t stream) {
  CUtensorMap q_map, do_map, k_map, v_map;
  int rc = make_maps<E, D>(&q_map, &do_map, &k_map, &v_map, q, k, v, dO, B, H,
                        S, T, st, kOwn, Cfg<D>::kStream);
  if (rc != 0) return rc;
  constexpr int smem = Cfg<D>::kSmem;
  static uint64_t smem_allowed = 0;  // devices where the limit is raised
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<E, D>, smem, smem_allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((S + kOwn - 1) / kOwn, B * H);
  flash_bwd_dq_kernel<E, D><<<grid, kThreads, smem, stream>>>(
      q_map, do_map, k_map, v_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta),
      static_cast<const float*>(dout_absmax),
      static_cast<typename E::T*>(dq), H, S, T, st.dq[0], st.dq[1], st.dq[2],
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO,
               const void* lse, const void* delta, const void* dout_absmax,
               void* dk, void* dv,
               void* dk_part, void* dv_part, int B, int H, int S, int T,
               int splits, int q_tiles_per_split, const Strides& st,
               float scale, cudaStream_t stream) {
  CUtensorMap q_map, do_map, k_map, v_map;
  int rc = make_maps<E, D>(&q_map, &do_map, &k_map, &v_map, q, k, v, dO, B, H,
                        S, T, st, Cfg<D>::kStream, kOwn);
  if (rc != 0) return rc;
  constexpr int smem = Cfg<D>::kSmem;
  static uint64_t smem_allowed = 0;  // devices where the limit is raised
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<E, D>, smem, smem_allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool split = splits > 1;
  dim3 grid((T + kOwn - 1) / kOwn, B * H, splits);
  flash_bwd_dkv_kernel<E, D><<<grid, kThreads, smem, stream>>>(
      k_map, v_map, q_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta),
      static_cast<const float*>(dout_absmax), static_cast<typename E::T*>(dk),
      static_cast<typename E::T*>(dv),
      split ? static_cast<float*>(dk_part) : nullptr,
      split ? static_cast<float*>(dv_part) : nullptr, H, S, T,
      q_tiles_per_split, st, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || !split) return static_cast<int>(e);
  const int64_t pairs = static_cast<int64_t>(B) * H * T * D / 2;
  const int threads = 256;
  dkv_reduce_kernel<E><<<static_cast<unsigned>((pairs + threads - 1) / threads),
                      threads, 0, stream>>>(
      static_cast<const float*>(dk_part), static_cast<const float*>(dv_part),
      static_cast<typename E::T*>(dk), static_cast<typename E::T*>(dv),
      splits, H, T, D, pairs, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int dq_d(const void* q, const void* k, const void* v, const void* dO,
         const void* lse, const void* delta, const void* dout_absmax,
         void* dq, int B, int H, int S,
         int T, int D, const int64_t* strides, float scale, void* stream) {
  const Strides st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dq<E, 16>(q, k, v, dO, lse, delta, dout_absmax, dq, B, H, S, T, st, scale, s);
    case 32: return launch_dq<E, 32>(q, k, v, dO, lse, delta, dout_absmax, dq, B, H, S, T, st, scale, s);
    case 64: return launch_dq<E, 64>(q, k, v, dO, lse, delta, dout_absmax, dq, B, H, S, T, st, scale, s);
    case 128: return launch_dq<E, 128>(q, k, v, dO, lse, delta, dout_absmax, dq, B, H, S, T, st, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename E>
int dkv_d(const void* q, const void* k, const void* v, const void* dO,
          const void* lse, const void* delta, const void* dout_absmax,
          void* dk, void* dv,
          void* dk_part, void* dv_part, int B, int H, int S, int T, int D,
          int splits, int q_tiles_per_split, const int64_t* strides,
          float scale, void* stream) {
  const Strides st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dkv<E, 16>(q, k, v, dO, lse, delta, dout_absmax, dk, dv, dk_part, dv_part, B, H, S, T, splits, q_tiles_per_split, st, scale, s);
    case 32: return launch_dkv<E, 32>(q, k, v, dO, lse, delta, dout_absmax, dk, dv, dk_part, dv_part, B, H, S, T, splits, q_tiles_per_split, st, scale, s);
    case 64: return launch_dkv<E, 64>(q, k, v, dO, lse, delta, dout_absmax, dk, dv, dk_part, dv_part, B, H, S, T, splits, q_tiles_per_split, st, scale, s);
    case 128: return launch_dkv<E, 128>(q, k, v, dO, lse, delta, dout_absmax, dk, dv, dk_part, dv_part, B, H, S, T, splits, q_tiles_per_split, st, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: 21 element strides, (batch, seq, head) for q, k, v, dO, dq, dk,
// dv in turn.  lse and delta are [B*H, S] fp32.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dO, const void* lse,
                                 const void* delta, void* dq, int B, int H,
                                 int S, int T, int D, const int64_t* strides,
                                 float scale, void* stream) {
  return dq_d<Bf16>(q, k, v, dO, lse, delta, nullptr, dq, B, H, S, T, D,
                    strides, scale, stream);
}

// dout_absmax: max|dO| as one fp32 value on the device (the dS factor).
extern "C" int flash_bwd_dq_f16(const void* q, const void* k, const void* v,
                                const void* dO, const void* lse,
                                const void* delta, const void* dout_absmax,
                                void* dq, int B, int H, int S, int T, int D,
                                const int64_t* strides, float scale,
                                void* stream) {
  return dq_d<F16>(q, k, v, dO, lse, delta, dout_absmax, dq, B, H, S, T, D,
                   strides, scale, stream);
}

// splits > 1 splits each kv tile's q loop over that many blocks of
// q_tiles_per_split q tiles, with fp32 partials in dk_part and dv_part
// ([splits, B*H, T, D] each) summed by the reduction kernel.
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k,
                                  const void* v, const void* dO,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, void* dk_part,
                                  void* dv_part, int B, int H, int S, int T,
                                  int D, int splits, int q_tiles_per_split,
                                  const int64_t* strides, float scale,
                                  void* stream) {
  return dkv_d<Bf16>(q, k, v, dO, lse, delta, nullptr, dk, dv, dk_part,
                     dv_part, B, H, S, T, D, splits, q_tiles_per_split,
                     strides, scale, stream);
}

extern "C" int flash_bwd_dkv_f16(const void* q, const void* k,
                                 const void* v, const void* dO,
                                 const void* lse, const void* delta,
                                 const void* dout_absmax,
                                 void* dk, void* dv, void* dk_part,
                                 void* dv_part, int B, int H, int S, int T,
                                 int D, int splits, int q_tiles_per_split,
                                 const int64_t* strides, float scale,
                                 void* stream) {
  return dkv_d<F16>(q, k, v, dO, lse, delta, dout_absmax, dk, dv, dk_part,
                    dv_part, B, H, S, T, D, splits, q_tiles_per_split,
                    strides, scale, stream);
}
