// Flash-attention backward in fp32 for Hopper (sm_90a), on the tensor
// cores: fp32 q, k, v, dO in, fp32 dq, dk, dv out, fp32 lse and
// Delta = rowsum(dO * O) (training.mixed_precision = "no").
//
// Replaces the Pallas kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` of
// sdxl_training_improvements_tpu/ops/flash_attention.py for fp32 inputs,
// where they multiply in fp32, and keeps their split, as the 16-bit kernels
// of flash_bwd.cu do:
//
// * dq: one block per (128-row q tile, batch*head), looping over kv tiles:
//   dq = sum_kv dS k, dS = P * (dP - Delta) * scale, P = exp(q k^T * scale
//   - lse), dP = dO v^T;
// * dk/dv: one block per (128-row kv tile, batch*head[, q split]), looping
//   over q tiles: dv = sum_q P^T dO, dk = sum_q dS^T q.
//
// Split TF32.  wgmma has no fp32 operands, and TF32 keeps 10 mantissa bits.
// Every operand enters as two TF32 parts, hi = rna(x) and lo = rna(x - hi)
// (hopper.cuh: Tf32), and every product as three TF32 products into one
// accumulator, the two small ones first: lo_a hi_b, hi_a lo_b, hi_a hi_b.
// The products keep about 2^-21 of relative accuracy against fp32's 2^-24
// (CUTLASS's OpMultiplyAddFastF32 on mma.sync does the same).  The tensor
// cores add into their fp32 accumulators by truncation, not rounding to
// nearest, so the gradient sums, which run over the whole sequence, take a
// fresh accumulator each streamed tile (its small products of all k steps
// first), added to the running sum by FADD.
//
// Bound: 6*S*T*D flops (dq) and 8*S*T*D (dk/dv), each at three TF32 products:
// 495 / 3 = 165 TFLOP/s of fp32-accurate products (1.56 and 2.08 ms at B4
// S=T=4096 H10 D64); the O((S + T) * D) bytes are far below that.
//
// Design, the warp-specialised shape of flash_bwd.cu:
//
// * three warpgroups a block: two consumers of 64 own rows each (q rows for
//   dq, kv rows for dk/dv) that keep their fp32 gradient sums in registers,
//   and a producer whose first warp issues TMA (4-D tensor maps over the
//   [B, N, H, D] strides) and whose other three warps split tiles;
//   setmaxnreg gives the consumers 232 registers and the producer 40;
// * the own tiles (q, dO; k, v) arrive once by TMA, raw.  Each k step of a
//   score product the consumers load their A fragments from them and split
//   them in registers (RS wgmma: A in registers, B in shared memory), which
//   keeps the own tiles at one fp32 copy and halves the shared-memory
//   traffic of a product against an SS wgmma;
// * the streamed tiles (kStream rows: 32, 16 at D = 128) arrive by TMA in a
//   ring of kStages stages (as many as shared memory holds, at most 3), an
//   mbarrier for the raw tiles, one for the split ones and one for their
//   release.  The splitting warps turn each raw tile, in place, into its hi
//   part and write its lo part beside it;
// * TF32 wgmma reads both operands K-major only (the transpose bits exist
//   for 16-bit types).  The score products (S = q k^T and dP = dO v^T;
//   S^T = k q^T and dP^T = v dO^T) are K-major as TMA lands them.  The
//   gradient products (dq = dS k, dv = P^T dO, dk = dS^T q) contract over
//   the streamed rows, so the splitting pass also writes the streamed tiles
//   they read (k; q and dO) transposed, hi and lo: the transpose costs the
//   pass's stores, not a pass of its own, and no register operand moves;
// * P and dS are formed in registers on the accumulator layout, split
//   there, and are the gradient products' A fragments.  A TF32 A fragment
//   holds columns t and t + 4 of each 8-column k step where the accumulator
//   holds 2t and 2t + 1: the transposed tiles hold their streamed rows in
//   that order (row 8n + pi(j) at column 8n + j, pi = 0 2 4 6 1 3 5 7), so
//   no value moves between threads.
//
// Shared memory per block (a build fact, `Cfg`): the two own tiles, and per
// stage the two raw-then-hi tiles, their lo tiles and the transposed hi and
// lo tiles (6 tiles for dq, 8 for dk/dv), each kStream x D fp32; at D = 64,
// 64 KB own + 3 x 48 KB (dq) or 2 x 64 KB (dk/dv).
//
// Masking from S and T, with no padded copies: TMA fills rows >= S and
// >= T with zeros; the dq kernel sets P = 0 in kv columns >= T, the dk/dv
// kernel gives q rows >= S an lse of +inf (so P = 0); rows beyond the
// sequence are never stored.  P = expf(s * scale - lse), as the plain
// version forms it.
//
// Small T (cross-attention, T = 77: one kv tile per head, too few blocks
// for 132 SMs): the wrapper splits the dk/dv q loop over `splits` blocks
// (ops/flash_attention.py: plan_dkv_splits on this kernel's kStream).
// Each writes fp32 partial dk and dv into scratch the wrapper allocates, and
// `flash_f32_dkv_reduce_kernel` sums them in split order.  No atomics
// anywhere: two launches give bit-equal gradients.
//
// C interface for ctypes; each launcher returns the cudaError_t of its
// launches (or hopper::kEncodeError + the CUresult of a tensor map it cannot
// build).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kOwn = 128;       // own rows a block, 64 per consumer
constexpr int kThreads = 384;   // 2 consumer warpgroups + the producer's
constexpr int kSplitters = 96;  // the producer's warps 1-3
constexpr int kSmemLimit = 232448;

template <int D, bool kDkv>
struct Cfg {
  // natural tiles ([rows][D] as TMA lands them): chunks of kNat columns,
  // each row of a chunk 4 * kNat bytes (128, or 64 at D = 16), swizzled
  static constexpr int kNat = D < 32 ? D : 32;
  static constexpr int kNatRow = 4 * kNat;
  static constexpr int kChunks = D / kNat;
  // streamed rows: the score products' N and the gradient products' K
  static constexpr int kStream = D <= 64 ? 32 : 16;
  // transposed tiles [D][kStream]: one chunk of 4 * kStream-byte rows
  static constexpr int kTRow = 4 * kStream;
  // columns of one gradient product (its wgmma N; 32 at D = 128, where the
  // consumers hold 2 x 128 gradient sums, keeps their registers unspilled)
  static constexpr int kN = D <= 64 ? D : 32;
  static constexpr int kOwnBytes = kOwn * D * 4;
  static constexpr int kTile = kStream * D * 4;
  // per stage: A, B raw then hi | A lo, B lo | A^T hi, A^T lo (| B^T hi,
  // B^T lo for dk/dv); A = k, B = v for dq, A = q, B = dO for dk/dv
  static constexpr int kTiles = kDkv ? 8 : 6;
  static constexpr int kStageBytes = kTiles * kTile;
  // lse and Delta of the streamed q rows (dk/dv), per stage
  static constexpr int kRowsBytes = kDkv ? 2 * kStream * 4 : 0;
  static constexpr int kFixed = 2 * kOwnBytes + 8 * (1 + 3 * 3) + 1024;
  static constexpr int kFit =
      (kSmemLimit - kFixed) / (kStageBytes + kRowsBytes);
  static constexpr int kStages = kFit < 3 ? kFit : 3;
  static_assert(kStages >= 1, "one stage of tiles exceeds shared memory");
  static constexpr int kRowsOffset = 2 * kOwnBytes + kStages * kStageBytes;
  static constexpr int kBarOffset = kRowsOffset + kStages * kRowsBytes;
  static constexpr int kSmem = kBarOffset + 8 * (1 + 3 * kStages) + 1024;
  static_assert(kSmem <= kSmemLimit, "tiles exceed shared memory");
  static_assert(kTile % 1024 == 0 && kOwnBytes % 1024 == 0,
                "tiles must start on the swizzle atom");
};

struct Strides {  // (batch, seq, head) element strides
  int64_t q[3], k[3], v[3], dO[3], dq[3], dk[3], dv[3];
};

// One block's shared memory, aligned to the 1024-byte swizzle atom, and its
// barriers initialised.
template <int D, bool kDkv>
struct Smem {
  using C = Cfg<D, kDkv>;
  unsigned char* generic;  // the aligned base as a generic pointer
  uint32_t base;

  __device__ __forceinline__ Smem(unsigned char* raw) {
    const uint32_t r = smem_u32(raw);
    base = (r + 1023) & ~1023u;
    generic = raw + (base - r);
    if (threadIdx.x == 0) {
      mbar_init(own_full(), 1);
      for (int i = 0; i < C::kStages; ++i) {
        mbar_init(raw_full(i), 1);
        mbar_init(split_full(i), kSplitters);
        mbar_init(empty(i), 2 * 128);
      }
      fence_barrier_init();
    }
    __syncthreads();
  }
  __device__ __forceinline__ uint32_t own(int i) const {
    return base + i * C::kOwnBytes;
  }
  __device__ __forceinline__ uint32_t tile(int st, int i) const {
    return base + 2 * C::kOwnBytes + st * C::kStageBytes + i * C::kTile;
  }
  template <typename T>
  __device__ __forceinline__ T* at(uint32_t addr) const {
    return reinterpret_cast<T*>(generic + (addr - base));
  }
  __device__ __forceinline__ float* lse(int st) const {
    return reinterpret_cast<float*>(generic + C::kRowsOffset +
                                    st * C::kRowsBytes);
  }
  __device__ __forceinline__ float* delta(int st) const {
    return lse(st) + C::kStream;
  }
  __device__ __forceinline__ uint32_t own_full() const {
    return base + C::kBarOffset;
  }
  __device__ __forceinline__ uint32_t raw_full(int st) const {
    return own_full() + 8 * (1 + st);
  }
  __device__ __forceinline__ uint32_t split_full(int st) const {
    return own_full() + 8 * (1 + C::kStages + st);
  }
  __device__ __forceinline__ uint32_t empty(int st) const {
    return own_full() + 8 * (1 + 2 * C::kStages + st);
  }
};

// Byte offset of element (r, d) in a natural tile of `rows` rows.
template <int D, bool kDkv, int ROWS>
__device__ __forceinline__ uint32_t nat_offset(int r, int d) {
  using C = Cfg<D, kDkv>;
  return (d / C::kNat) * ROWS * C::kNatRow +
         swizzled<C::kNatRow / 2>(r, (d % C::kNat) * 4);
}

// Load the block's own rows [r0, r0 + 128) of two tensors.
template <int D, bool kDkv>
__device__ __forceinline__ void load_own(const Smem<D, kDkv>& sm,
                                         const CUtensorMap* a,
                                         const CUtensorMap* b, int h, int r0,
                                         int bb) {
  using C = Cfg<D, kDkv>;
  mbar_arrive_expect_tx(sm.own_full(), 2 * C::kOwnBytes);
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c) {
    tma_load_4d(sm.own(0) + c * kOwn * C::kNatRow, a, sm.own_full(),
                c * C::kNat, h, r0, bb);
    tma_load_4d(sm.own(1) + c * kOwn * C::kNatRow, b, sm.own_full(),
                c * C::kNat, h, r0, bb);
  }
}

// Load the streamed rows [r0, r0 + kStream) of two tensors into stage st.
template <int D, bool kDkv>
__device__ __forceinline__ void load_stream(const Smem<D, kDkv>& sm, int st,
                                            const CUtensorMap* a,
                                            const CUtensorMap* b, int h,
                                            int r0, int bb) {
  using C = Cfg<D, kDkv>;
  mbar_arrive_expect_tx(sm.raw_full(st), 2 * C::kTile);
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c) {
    tma_load_4d(sm.tile(st, 0) + c * C::kStream * C::kNatRow, a,
                sm.raw_full(st), c * C::kNat, h, r0, bb);
    tma_load_4d(sm.tile(st, 1) + c * C::kStream * C::kNatRow, b,
                sm.raw_full(st), c * C::kNat, h, r0, bb);
  }
}

// The splitting pass over stage st, by the 96 threads u of warps 1-3: each
// raw tile (A, B) in place to its hi part, its lo part beside it, and A
// (and for dk/dv B) transposed, hi and lo, in the order of the A fragments
// (the note at the top).  A warp takes 4 columns of kStream rows at a time:
// 16-byte loads and stores of the natural tiles, one transposed row a
// store, both free of bank conflicts.
template <int D, bool kDkv>
__device__ __forceinline__ void split_stage(const Smem<D, kDkv>& sm, int st,
                                            int u) {
  using C = Cfg<D, kDkv>;
  constexpr int kUnits = C::kStream * D / 4;  // float4s in a tile
  for (int i = u; i < 2 * kUnits; i += kSplitters) {
    const int x = i / kUnits;  // 0: A, 1: B
    const int unit = i - x * kUnits;
    const int r = unit % C::kStream;
    const int d = (unit / C::kStream) * 4;
    const uint32_t off = nat_offset<D, kDkv, C::kStream>(r, d);
    float4* hi_p = sm.template at<float4>(sm.tile(st, x) + off);
    const float4 raw = *hi_p;
    const float vals[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) Tf32::split(vals[j], hi[j], lo[j]);
    *reinterpret_cast<uint4*>(hi_p) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *sm.template at<uint4>(sm.tile(st, 2 + x) + off) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
    if (x == 0 || kDkv) {
      // column of streamed row r in the transposed tiles
      const int p = (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t t_off = swizzled<C::kTRow / 2>(d + j, p * 4);
        *sm.template at<uint32_t>(sm.tile(st, 4 + 2 * x) + t_off) = hi[j];
        *sm.template at<uint32_t>(sm.tile(st, 5 + 2 * x) + t_off) = lo[j];
      }
    }
  }
}

// The split A fragment of k step kk of the consumer's rows (row, row + 8)
// in an own tile: columns 8 kk + t and 8 kk + t + 4.
template <int D, bool kDkv>
__device__ __forceinline__ void own_fragment(const Smem<D, kDkv>& sm,
                                             uint32_t tile, int row, int kk,
                                             int t, uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  const int col = 8 * kk + t;
  const float* p = sm.template at<float>(tile);
  const float a[4] = {
      p[nat_offset<D, kDkv, kOwn>(row, col) / 4],
      p[nat_offset<D, kDkv, kOwn>(row + 8, col) / 4],
      p[nat_offset<D, kDkv, kOwn>(row, col + 4) / 4],
      p[nat_offset<D, kDkv, kOwn>(row + 8, col + 4) / 4]};
#pragma unroll
  for (int j = 0; j < 4; ++j) Tf32::split(a[j], hi[j], lo[j]);
}

// Descriptor of k step kk of a natural streamed tile (the B operand of a
// score product: kStream rows, K = D).
template <int D, bool kDkv>
__device__ __forceinline__ uint64_t nat_desc(uint32_t tile, int kk) {
  using C = Cfg<D, kDkv>;
  constexpr int kSteps = C::kNat / 8;  // k steps in a chunk row
  return desc_k<C::kNatRow / 2>(tile + (kk / kSteps) * C::kStream *
                                           C::kNatRow +
                                (kk % kSteps) * 32);
}

// S = A B^T and P = A' B'^T over D (64 x kStream each): A, A' the
// consumer's own rows (split fragments from an own tile), B, B' natural
// streamed tiles as their hi and lo parts; each k step's small products
// before its hi * hi, one k step's fragments loaded while the last one's
// products run.  Returns with the products complete.
template <int D, bool kDkv>
__device__ __forceinline__ void scores2(
    const Smem<D, kDkv>& sm, int row, int t,
    float (&s)[Cfg<D, kDkv>::kStream / 2], uint32_t own_s, uint32_t s_hi,
    uint32_t s_lo, float (&p)[Cfg<D, kDkv>::kStream / 2], uint32_t own_p,
    uint32_t p_hi, uint32_t p_lo) {
  constexpr int kStream = Cfg<D, kDkv>::kStream;
#pragma unroll
  for (int i = 0; i < kStream / 2; ++i) s[i] = p[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t sh[4], sl[4], ph[4], pl[4];
    own_fragment<D, kDkv>(sm, own_s, row, kk, t, sh, sl);
    own_fragment<D, kDkv>(sm, own_p, row, kk, t, ph, pl);
    const uint64_t bsh = nat_desc<D, kDkv>(s_hi, kk);
    const uint64_t bph = nat_desc<D, kDkv>(p_hi, kk);
    wgmma_fence();
    wgmma_rs<Tf32, kStream>(s, sl, bsh);
    wgmma_rs<Tf32, kStream>(s, sh, nat_desc<D, kDkv>(s_lo, kk));
    wgmma_rs<Tf32, kStream>(s, sh, bsh);
    wgmma_rs<Tf32, kStream>(p, pl, bph);
    wgmma_rs<Tf32, kStream>(p, ph, nat_desc<D, kDkv>(p_lo, kk));
    wgmma_rs<Tf32, kStream>(p, ph, bph);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_operands(s);
  fence_operands(p);
}

// A fragments (hi, lo) of k steps of the values v on the accumulator layout:
// k step n takes accumulator columns 8n + 2t, 8n + 2t + 1 as its columns t,
// t + 4, the order of the transposed tiles' rows.
template <int N>
__device__ __forceinline__ void acc_fragments(const float (&v)[N / 2],
                                              uint32_t (&hi)[N / 8][4],
                                              uint32_t (&lo)[N / 8][4]) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    Tf32::split(v[4 * n + 0], hi[n][0], lo[n][0]);
    Tf32::split(v[4 * n + 2], hi[n][1], lo[n][1]);
    Tf32::split(v[4 * n + 1], hi[n][2], lo[n][2]);
    Tf32::split(v[4 * n + 3], hi[n][3], lo[n][3]);
  }
}

// acc[64 x kN] += X B over the streamed rows: X as split A fragments, B
// columns [c kN, c kN + kN) of a transposed tile (hi and lo).  The products
// go into a fresh accumulator, the small ones of every k step first, which
// is added to acc by FADD.
template <int D, bool kDkv>
__device__ __forceinline__ void gradient(
    float (&acc)[Cfg<D, kDkv>::kN / 2],
    const uint32_t (&xh)[Cfg<D, kDkv>::kStream / 8][4],
    const uint32_t (&xl)[Cfg<D, kDkv>::kStream / 8][4], uint32_t t_hi,
    uint32_t t_lo, int c) {
  using C = Cfg<D, kDkv>;
  float part[C::kN / 2];
#pragma unroll
  for (int i = 0; i < C::kN / 2; ++i) part[i] = 0.f;
  const uint32_t rows = c * C::kN * C::kTRow;
  wgmma_fence();
#pragma unroll
  for (int n = 0; n < C::kStream / 8; ++n) {
    wgmma_rs<Tf32, C::kN>(part, xl[n],
                          desc_k<C::kTRow / 2>(t_hi + rows + n * 32));
    wgmma_rs<Tf32, C::kN>(part, xh[n],
                          desc_k<C::kTRow / 2>(t_lo + rows + n * 32));
  }
#pragma unroll
  for (int n = 0; n < C::kStream / 8; ++n) {
    wgmma_rs<Tf32, C::kN>(part, xh[n],
                          desc_k<C::kTRow / 2>(t_hi + rows + n * 32));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(part);
#pragma unroll
  for (int i = 0; i < C::kN / 2; ++i) acc[i] += part[i];
}

// Store rows r0 and r0 + 8 (< n) of the accumulators [64 x D] at `base`
// (row stride `row_stride` floats).
template <int D, bool kDkv>
__device__ __forceinline__ void store_rows(
    float* base, int64_t row_stride,
    const float (&acc)[D / Cfg<D, kDkv>::kN][Cfg<D, kDkv>::kN / 2], int r0,
    int n, int t) {
  constexpr int kN = Cfg<D, kDkv>::kN;
#pragma unroll
  for (int c = 0; c < D / kN; ++c) {
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int col = c * kN + 8 * j + 2 * t;
      if (r0 < n) {
        *reinterpret_cast<float2*>(base + r0 * row_stride + col) =
            make_float2(acc[c][4 * j], acc[c][4 * j + 1]);
      }
      if (r0 + 8 < n) {
        *reinterpret_cast<float2*>(base + (r0 + 8) * row_stride + col) =
            make_float2(acc[c][4 * j + 2], acc[c][4 * j + 3]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_f32_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int S, int T, int64_t dq_sb, int64_t dq_ss,
                    int64_t dq_sh, float scale) {
  using C = Cfg<D, false>;
  constexpr int kStream = C::kStream;
  extern __shared__ unsigned char smem_raw[];
  const Smem<D, false> sm(smem_raw);
  const int m0 = blockIdx.x * kOwn;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int n_tiles = (T + kStream - 1) / kStream;

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer: own q, dO; streamed k, v
    setmaxnreg_dec<40>();
    const int u = threadIdx.x - 256;
    if (u == 0) {
      load_own<D, false>(sm, &q_map, &do_map, h, m0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % C::kStages;
        mbar_wait(sm.empty(st), ((j / C::kStages) & 1) ^ 1);
        load_stream<D, false>(sm, st, &k_map, &v_map, h, j * kStream, b);
      }
    } else if (u >= 32) {
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % C::kStages;
        mbar_wait(sm.raw_full(st), (j / C::kStages) & 1);
        split_stage<D, false>(sm, st, u - 32);
        fence_proxy_async();
        mbar_arrive(sm.split_full(st));
      }
    }
  } else {  // consumers: warpgroup wg owns q rows [wg * 64, wg * 64 + 64)
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128;
    const int lane = tid & 31;
    const int t = lane & 3;
    const int row = wg * 64 + (tid >> 5) * 16 + (lane >> 2);
    const int r0 = m0 + row;
    const int r1 = r0 + 8;
    const int64_t rows = static_cast<int64_t>(bh) * S;
    // rows >= S hold zeros in q and dO, so dS is 0 there for any lse
    const float lse0 = r0 < S ? lse[rows + r0] : 0.f;
    const float lse1 = r1 < S ? lse[rows + r1] : 0.f;
    const float dl0 = r0 < S ? delta[rows + r0] : 0.f;
    const float dl1 = r1 < S ? delta[rows + r1] : 0.f;

    float acc[D / C::kN][C::kN / 2];
#pragma unroll
    for (int c = 0; c < D / C::kN; ++c) {
#pragma unroll
      for (int i = 0; i < C::kN / 2; ++i) acc[c][i] = 0.f;
    }
    float s[kStream / 2], dp[kStream / 2];
    uint32_t dsh[kStream / 8][4], dsl[kStream / 8][4];

    mbar_wait(sm.own_full(), 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % C::kStages;
      mbar_wait(sm.split_full(st), (j / C::kStages) & 1);
      // S = q k^T, dP = dO v^T
      scores2<D, false>(sm, row, t, s, sm.own(0), sm.tile(st, 0),
                        sm.tile(st, 2), dp, sm.own(1), sm.tile(st, 1),
                        sm.tile(st, 3));
      // s[4 n + e]: row r0 (e < 2) or r1, kv column n0 + 8 n + 2 t + e % 2
      const int n0 = j * kStream;
#pragma unroll
      for (int n = 0; n < kStream / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = n0 + 8 * n + 2 * t + (e & 1) < T;
          const float p =
              valid ? expf(s[4 * n + e] * scale - (e < 2 ? lse0 : lse1))
                    : 0.f;
          s[4 * n + e] = p * (dp[4 * n + e] - (e < 2 ? dl0 : dl1)) * scale;
        }
      }
      acc_fragments<kStream>(s, dsh, dsl);
      fence_operands(dsh);
      fence_operands(dsl);
#pragma unroll
      for (int c = 0; c < D / C::kN; ++c) {  // dq += dS k
        gradient<D, false>(acc[c], dsh, dsl, sm.tile(st, 4), sm.tile(st, 5),
                           c);
      }
      mbar_arrive(sm.empty(st));
    }
    store_rows<D, false>(dq + b * dq_sb + h * dq_sh, dq_ss, acc, r0, S, t);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_f32_dkv_kernel(const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv,
                     float* __restrict__ dk_part, float* __restrict__ dv_part,
                     int H, int S, int T, int q_tiles_per_split, Strides st,
                     float scale) {
  using C = Cfg<D, true>;
  constexpr int kStream = C::kStream;
  extern __shared__ unsigned char smem_raw[];
  const Smem<D, true> sm(smem_raw);
  const int n0 = blockIdx.x * kOwn;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q_tiles = (S + kStream - 1) / kStream;
  const int first = blockIdx.z * q_tiles_per_split;
  const int n_tiles = min(q_tiles_per_split, q_tiles - first);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer: own k, v; streamed q, dO, lse, Delta
    setmaxnreg_dec<40>();
    const int u = threadIdx.x - 256;
    if (u == 0) {
      load_own<D, true>(sm, &k_map, &v_map, h, n0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % C::kStages;
        mbar_wait(sm.empty(s), ((i / C::kStages) & 1) ^ 1);
        load_stream<D, true>(sm, s, &q_map, &do_map, h,
                             (first + i) * kStream, b);
      }
    } else if (u >= 32) {
      const int64_t rows = static_cast<int64_t>(bh) * S;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % C::kStages;
        const int m = (first + i) * kStream;
        mbar_wait(sm.raw_full(s), (i / C::kStages) & 1);
        split_stage<D, true>(sm, s, u - 32);
        // q rows >= S: lse = +inf, so P = expf(-inf) = 0 there
        if (u - 32 < kStream) {
          const int r = u - 32;
          const bool in = m + r < S;
          sm.lse(s)[r] = in ? lse[rows + m + r] : __int_as_float(0x7f800000);
          sm.delta(s)[r] = in ? delta[rows + m + r] : 0.f;
        }
        fence_proxy_async();
        mbar_arrive(sm.split_full(s));
      }
    }
  } else {  // consumers: warpgroup wg owns kv rows [wg * 64, wg * 64 + 64)
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128;
    const int lane = tid & 31;
    const int t = lane & 3;
    const int row = wg * 64 + (tid >> 5) * 16 + (lane >> 2);

    float dk_acc[D / C::kN][C::kN / 2], dv_acc[D / C::kN][C::kN / 2];
#pragma unroll
    for (int c = 0; c < D / C::kN; ++c) {
#pragma unroll
      for (int i = 0; i < C::kN / 2; ++i) dk_acc[c][i] = dv_acc[c][i] = 0.f;
    }
    float s[kStream / 2], dp[kStream / 2];
    uint32_t ph[kStream / 8][4], pl[kStream / 8][4];
    uint32_t dsh[kStream / 8][4], dsl[kStream / 8][4];

    mbar_wait(sm.own_full(), 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s_ = i % C::kStages;
      mbar_wait(sm.split_full(s_), (i / C::kStages) & 1);
      // S^T = k q^T, dP^T = v dO^T
      scores2<D, true>(sm, row, t, s, sm.own(0), sm.tile(s_, 0),
                       sm.tile(s_, 2), dp, sm.own(1), sm.tile(s_, 1),
                       sm.tile(s_, 3));
      // s[4 n + e]: kv row (e < 2) or row + 8, q column 8 n + 2 t + e % 2
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
              expf(s[4 * n + e] * scale - ((e & 1) ? l.y : l.x));
          s[4 * n + e] = p;
          dp[4 * n + e] = p * (dp[4 * n + e] - ((e & 1) ? dl.y : dl.x)) *
                          scale;
        }
      }
      acc_fragments<kStream>(s, ph, pl);
      acc_fragments<kStream>(dp, dsh, dsl);
      fence_operands(ph);
      fence_operands(pl);
      fence_operands(dsh);
      fence_operands(dsl);
#pragma unroll
      for (int c = 0; c < D / C::kN; ++c) {
        // dv += P^T dO, dk += dS^T q
        gradient<D, true>(dv_acc[c], ph, pl, sm.tile(s_, 6), sm.tile(s_, 7),
                          c);
        gradient<D, true>(dk_acc[c], dsh, dsl, sm.tile(s_, 4),
                          sm.tile(s_, 5), c);
      }
      mbar_arrive(sm.empty(s_));
    }
    const int r0 = n0 + row;
    if (dk_part != nullptr) {
      const int64_t part =
          (static_cast<int64_t>(blockIdx.z) * gridDim.y + bh) * T * D;
      store_rows<D, true>(dk_part + part, D, dk_acc, r0, T, t);
      store_rows<D, true>(dv_part + part, D, dv_acc, r0, T, t);
    } else {
      store_rows<D, true>(dk + b * st.dk[0] + h * st.dk[2], st.dk[1], dk_acc,
                          r0, T, t);
      store_rows<D, true>(dv + b * st.dv[0] + h * st.dv[2], st.dv[1], dv_acc,
                          r0, T, t);
    }
  }
}

// dk, dv = sum over splits of the fp32 partials [splits, B*H, T, D], in
// split order; one thread per pair of columns.
__global__ void flash_f32_dkv_reduce_kernel(const float* __restrict__ dk_part,
                                            const float* __restrict__ dv_part,
                                            float* __restrict__ dk,
                                            float* __restrict__ dv,
                                            int splits, int H, int T, int D,
                                            int64_t pairs, Strides st) {
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
  *reinterpret_cast<float2*>(dk + b * st.dk[0] + t * st.dk[1] + h * st.dk[2] +
                             d) = k2;
  *reinterpret_cast<float2*>(dv + b * st.dv[0] + t * st.dv[1] + h * st.dv[2] +
                             d) = v2;
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
// `kv_rows` rows and kNat columns.
template <int D>
int make_maps(CUtensorMap* q_map, CUtensorMap* do_map, CUtensorMap* k_map,
              CUtensorMap* v_map, const void* q, const void* k, const void* v,
              const void* dO, int B, int H, int S, int T, const Strides& st,
              int q_rows, int kv_rows) {
  constexpr int kNat = Cfg<D, false>::kNat;
  int rc = make_map<Tf32, kNat>(q_map, q, B, S, H, D, st.q[0], st.q[1],
                                st.q[2], q_rows);
  if (rc == 0) {
    rc = make_map<Tf32, kNat>(do_map, dO, B, S, H, D, st.dO[0], st.dO[1],
                              st.dO[2], q_rows);
  }
  if (rc == 0) {
    rc = make_map<Tf32, kNat>(k_map, k, B, T, H, D, st.k[0], st.k[1],
                              st.k[2], kv_rows);
  }
  if (rc == 0) {
    rc = make_map<Tf32, kNat>(v_map, v, B, T, H, D, st.v[0], st.v[1],
                              st.v[2], kv_rows);
  }
  return rc;
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dO,
              const void* lse, const void* delta, void* dq, int B, int H,
              int S, int T, const Strides& st, float scale,
              cudaStream_t stream) {
  using C = Cfg<D, false>;
  CUtensorMap q_map, do_map, k_map, v_map;
  int rc = make_maps<D>(&q_map, &do_map, &k_map, &v_map, q, k, v, dO, B, H,
                        S, T, st, kOwn, C::kStream);
  if (rc != 0) return rc;
  static uint64_t smem_allowed = 0;  // devices where the limit is raised
  cudaError_t e = allow_smem(flash_f32_dq_kernel<D>, C::kSmem, smem_allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((S + kOwn - 1) / kOwn, B * H);
  flash_f32_dq_kernel<D><<<grid, kThreads, C::kSmem, stream>>>(
      q_map, do_map, k_map, v_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), H, S, T,
      st.dq[0], st.dq[1], st.dq[2], scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO,
               const void* lse, const void* delta, void* dk, void* dv,
               void* dk_part, void* dv_part, int B, int H, int S, int T,
               int splits, int q_tiles_per_split, const Strides& st,
               float scale, cudaStream_t stream) {
  using C = Cfg<D, true>;
  CUtensorMap q_map, do_map, k_map, v_map;
  int rc = make_maps<D>(&q_map, &do_map, &k_map, &v_map, q, k, v, dO, B, H,
                        S, T, st, C::kStream, kOwn);
  if (rc != 0) return rc;
  static uint64_t smem_allowed = 0;
  cudaError_t e = allow_smem(flash_f32_dkv_kernel<D>, C::kSmem, smem_allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool split = splits > 1;
  dim3 grid((T + kOwn - 1) / kOwn, B * H, splits);
  flash_f32_dkv_kernel<D><<<grid, kThreads, C::kSmem, stream>>>(
      k_map, v_map, q_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), split ? static_cast<float*>(dk_part) : nullptr,
      split ? static_cast<float*>(dv_part) : nullptr, H, S, T,
      q_tiles_per_split, st, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || !split) return static_cast<int>(e);
  const int64_t pairs = static_cast<int64_t>(B) * H * T * D / 2;
  const int threads = 256;
  flash_f32_dkv_reduce_kernel<<<
      static_cast<unsigned>((pairs + threads - 1) / threads), threads, 0,
      stream>>>(static_cast<const float*>(dk_part),
                static_cast<const float*>(dv_part), static_cast<float*>(dk),
                static_cast<float*>(dv), splits, H, T, D, pairs, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 21 element strides, (batch, seq, head) for q, k, v, dO, dq, dk,
// dv in turn.  lse and delta are [B*H, S] fp32.
extern "C" int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                const void* dO, const void* lse,
                                const void* delta, void* dq, int B, int H,
                                int S, int T, int D, const int64_t* strides,
                                float scale, void* stream) {
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

// splits > 1 splits each kv tile's q loop over that many blocks of
// q_tiles_per_split q tiles, with fp32 partials in dk_part and dv_part
// ([splits, B*H, T, D] each) summed by the reduction kernel.
extern "C" int flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                 const void* dO, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 void* dk_part, void* dv_part, int B, int H,
                                 int S, int T, int D, int splits,
                                 int q_tiles_per_split,
                                 const int64_t* strides, float scale,
                                 void* stream) {
  const Strides st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dkv<16>(q, k, v, dO, lse, delta, dk, dv, dk_part, dv_part, B, H, S, T, splits, q_tiles_per_split, st, scale, s);
    case 32: return launch_dkv<32>(q, k, v, dO, lse, delta, dk, dv, dk_part, dv_part, B, H, S, T, splits, q_tiles_per_split, st, scale, s);
    case 64: return launch_dkv<64>(q, k, v, dO, lse, delta, dk, dv, dk_part, dv_part, B, H, S, T, splits, q_tiles_per_split, st, scale, s);
    case 128: return launch_dkv<128>(q, k, v, dO, lse, delta, dk, dv, dk_part, dv_part, B, H, S, T, splits, q_tiles_per_split, st, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
