// The pieces the fp32 flash-attention kernels share (flash_f32.cu: the
// forward; flash_bwd_f32.cu: dq and dk/dv), all on split-TF32 wgmma
// (hopper.cuh: Tf32) in one warp-specialised block shape:
//
// * two consumer warpgroups of 64 own rows each, which keep their fp32 sums
//   in registers, and one or two producer warpgroups whose first warp issues
//   TMA (4-D tensor maps over the [B, N, H, D] strides) and whose other
//   warps split the streamed tiles (`split_stage`);
// * the own tiles (q, dO; k, v) arrive once by TMA, raw, and the consumers
//   split their A fragments in registers each k step (`own_fragment`, RS
//   wgmma);
// * the streamed tiles arrive by TMA in a ring of up to 3 stages, with an
//   mbarrier for the raw tiles, one for the split ones and one for their
//   release.  The splitting warps turn a raw tile that a score product
//   reads into its hi part in place, with its lo part beside it (natural,
//   K-major as TMA lands it), and write a tile that a product contracts
//   over the streamed rows transposed, hi and lo: TF32 wgmma reads both
//   operands K-major only;
// * a product over the streamed rows takes its A fragments from values on
//   the accumulator layout (`acc_fragments`).  A TF32 A fragment holds
//   columns t and t + 4 of each 8-column k step where the accumulator holds
//   2t and 2t + 1, so the transposed tiles hold their streamed rows in that
//   order (row 8n + pi(j) at column 8n + j, pi = 0 2 4 6 1 3 5 7) and no
//   value moves between threads.  The tensor cores add into fp32 by
//   truncation, so such a product, whose sum runs over the whole sequence,
//   goes into a fresh accumulator each streamed tile (its small products of
//   every k step first), added to the running sum by FADD.
//
// Each kernel names its geometry as a `Geometry` and its splitting pass as
// four functions of the streamed tile x (0 or 1): natural(x), lo_slot(x),
// transposed(x), t_slot(x).

#pragma once

#include "hopper.cuh"

namespace flash_f32 {

using namespace hopper;

constexpr int kOwn = 128;  // own rows a block, 64 per consumer
constexpr int kSmemLimit = 232448;

// One kernel's tiles: head dim D_, STREAM streamed rows a stage, OWN own
// tiles, TILES streamed tiles a stage, ROWS bytes of per-row values a stage
// (lse and Delta of the dk/dv kernel), N columns of one product over the
// streamed rows (its wgmma N), PRODUCERS producer warpgroups.
template <int D_, int STREAM, int OWN, int TILES, int ROWS, int N,
          int PRODUCERS>
struct Geometry {
  static constexpr int D = D_;
  // the consumers' two warpgroups and the producers'; the producers' warps
  // but the first split
  static constexpr int kThreads = 128 * (2 + PRODUCERS);
  static constexpr int kSplitters = 128 * PRODUCERS - 32;
  // natural tiles ([rows][D] as TMA lands them): chunks of kNat columns,
  // each row of a chunk 4 * kNat bytes (128, or 64 at D = 16), swizzled
  static constexpr int kNat = D < 32 ? D : 32;
  static constexpr int kNatRow = 4 * kNat;
  static constexpr int kChunks = D / kNat;
  // streamed rows: the score products' N and the other products' K
  static constexpr int kStream = STREAM;
  // transposed tiles [D][kStream]: chunks of kTCols columns, rows of kTRow
  // bytes
  static constexpr int kTCols = STREAM < 32 ? STREAM : 32;
  static constexpr int kTRow = 4 * kTCols;
  static constexpr int kTChunk = D * kTRow;
  static constexpr int kN = N;
  static constexpr int kOwnTiles = OWN;
  static constexpr int kOwnBytes = kOwn * D * 4;
  static constexpr int kTile = kStream * D * 4;
  static constexpr int kTiles = TILES;
  static constexpr int kStageBytes = kTiles * kTile;
  static constexpr int kRowsBytes = ROWS;
  static constexpr int kFixed = OWN * kOwnBytes + 8 * (1 + 3 * 3) + 1024;
  static constexpr int kFit =
      (kSmemLimit - kFixed) / (kStageBytes + kRowsBytes);
  static constexpr int kStages = kFit < 3 ? kFit : 3;
  static_assert(kStages >= 1, "one stage of tiles exceeds shared memory");
  static constexpr int kRowsOffset = OWN * kOwnBytes + kStages * kStageBytes;
  static constexpr int kBarOffset = kRowsOffset + kStages * kRowsBytes;
  static constexpr int kSmem = kBarOffset + 8 * (1 + 3 * kStages) + 1024;
  static_assert(kSmem <= kSmemLimit, "tiles exceed shared memory");
  static_assert(kTile % 1024 == 0 && kOwnBytes % 1024 == 0 &&
                    kTChunk % 1024 == 0,
                "tiles must start on the swizzle atom");
};

// One block's shared memory, aligned to the 1024-byte swizzle atom, and its
// barriers initialised.
template <class C>
struct Smem {
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
        mbar_init(split_full(i), C::kSplitters);
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
    return base + C::kOwnTiles * C::kOwnBytes + st * C::kStageBytes +
           i * C::kTile;
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
template <class C, int ROWS>
__device__ __forceinline__ uint32_t nat_offset(int r, int d) {
  return (d / C::kNat) * ROWS * C::kNatRow +
         swizzled<C::kNatRow / 2>(r, (d % C::kNat) * 4);
}

// Load the block's own rows [r0, r0 + 128) of its own tiles (a; b when it
// has two).
template <class C>
__device__ __forceinline__ void load_own(const Smem<C>& sm,
                                         const CUtensorMap* a,
                                         const CUtensorMap* b, int h, int r0,
                                         int bb) {
  mbar_arrive_expect_tx(sm.own_full(), C::kOwnTiles * C::kOwnBytes);
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c) {
    tma_load_4d(sm.own(0) + c * kOwn * C::kNatRow, a, sm.own_full(),
                c * C::kNat, h, r0, bb);
    if constexpr (C::kOwnTiles == 2) {
      tma_load_4d(sm.own(1) + c * kOwn * C::kNatRow, b, sm.own_full(),
                  c * C::kNat, h, r0, bb);
    }
  }
}

// Load the streamed rows [r0, r0 + kStream) of two tensors into tiles 0
// and 1 of stage st.
template <class C>
__device__ __forceinline__ void load_stream(const Smem<C>& sm, int st,
                                            const CUtensorMap* a,
                                            const CUtensorMap* b, int h,
                                            int r0, int bb) {
  mbar_arrive_expect_tx(sm.raw_full(st), 2 * C::kTile);
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c) {
    tma_load_4d(sm.tile(st, 0) + c * C::kStream * C::kNatRow, a,
                sm.raw_full(st), c * C::kNat, h, r0, bb);
    tma_load_4d(sm.tile(st, 1) + c * C::kStream * C::kNatRow, b,
                sm.raw_full(st), c * C::kNat, h, r0, bb);
  }
}

// Byte offset of (row d, column p) in a transposed tile.
template <class C>
__device__ __forceinline__ uint32_t t_offset(int d, int p) {
  if constexpr (C::kTCols == C::kStream) {
    return swizzled<C::kTRow / 2>(d, p * 4);
  } else {
    return (p / C::kTCols) * C::kTChunk +
           swizzled<C::kTRow / 2>(d, (p % C::kTCols) * 4);
  }
}

// The splitting pass over stage st, by the kSplitters threads u: each
// raw tile x (0, 1) split into its parts: natural(x) writes its hi part in
// place and its lo part at tile lo_slot(x); transposed(x) writes its hi and
// lo parts transposed, in the order of the A fragments (the note at the
// top), at tiles t_slot(x) and t_slot(x) + 1.  A warp takes 4 columns of
// kStream rows at a time: 16-byte loads and stores of the natural tiles,
// one transposed row a store, both free of bank conflicts.
template <class C>
__device__ __forceinline__ void split_stage(const Smem<C>& sm, int st,
                                            int u) {
  constexpr int kUnits = C::kStream * C::D / 4;  // float4s in a tile
  for (int i = u; i < 2 * kUnits; i += C::kSplitters) {
    const int x = i / kUnits;
    const int unit = i - x * kUnits;
    const int r = unit % C::kStream;
    const int d = (unit / C::kStream) * 4;
    const uint32_t off = nat_offset<C, C::kStream>(r, d);
    float4* hi_p = sm.template at<float4>(sm.tile(st, x) + off);
    const float4 raw = *hi_p;
    const float vals[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) Tf32::split(vals[j], hi[j], lo[j]);
    if (C::natural(x)) {
      *reinterpret_cast<uint4*>(hi_p) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *sm.template at<uint4>(sm.tile(st, C::lo_slot(x)) + off) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    if (C::transposed(x)) {
      // column of streamed row r in the transposed tiles
      const int p = (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
      const int ts = C::t_slot(x);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t t_off = t_offset<C>(d + j, p);
        *sm.template at<uint32_t>(sm.tile(st, ts) + t_off) = hi[j];
        *sm.template at<uint32_t>(sm.tile(st, ts + 1) + t_off) = lo[j];
      }
    }
  }
}

// The split A fragment of k step kk of the consumer's rows (row, row + 8)
// in an own tile: columns 8 kk + t and 8 kk + t + 4.
template <class C>
__device__ __forceinline__ void own_fragment(const Smem<C>& sm,
                                             uint32_t tile, int row, int kk,
                                             int t, uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  const int col = 8 * kk + t;
  const float* p = sm.template at<float>(tile);
  const float a[4] = {p[nat_offset<C, kOwn>(row, col) / 4],
                      p[nat_offset<C, kOwn>(row + 8, col) / 4],
                      p[nat_offset<C, kOwn>(row, col + 4) / 4],
                      p[nat_offset<C, kOwn>(row + 8, col + 4) / 4]};
#pragma unroll
  for (int j = 0; j < 4; ++j) Tf32::split(a[j], hi[j], lo[j]);
}

// Descriptor of k step kk of a natural streamed tile (the B operand of a
// score product: kStream rows, K = D).
template <class C>
__device__ __forceinline__ uint64_t nat_desc(uint32_t tile, int kk) {
  constexpr int kSteps = C::kNat / 8;  // k steps in a chunk row
  return desc_k<C::kNatRow / 2>(tile + (kk / kSteps) * C::kStream *
                                           C::kNatRow +
                                (kk % kSteps) * 32);
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

// Issue part[64 x kN] = X B over the streamed rows, committed and not
// waited for: X as split A fragments, B columns [c kN, c kN + kN) of a
// transposed tile (hi and lo), the small products of every k step first.
template <class C>
__device__ __forceinline__ void issue_over_stream(
    float (&part)[C::kN / 2], const uint32_t (&xh)[C::kStream / 8][4],
    const uint32_t (&xl)[C::kStream / 8][4], uint32_t t_hi, uint32_t t_lo,
    int c) {
  constexpr int kSteps = C::kTCols / 8;  // k steps in a chunk row
#pragma unroll
  for (int i = 0; i < C::kN / 2; ++i) part[i] = 0.f;
  const uint32_t rows = c * C::kN * C::kTRow;
  wgmma_fence();
#pragma unroll
  for (int n = 0; n < C::kStream / 8; ++n) {
    const uint32_t at = (n / kSteps) * C::kTChunk + rows + (n % kSteps) * 32;
    wgmma_rs<Tf32, C::kN>(part, xl[n], desc_k<C::kTRow / 2>(t_hi + at));
    wgmma_rs<Tf32, C::kN>(part, xh[n], desc_k<C::kTRow / 2>(t_lo + at));
  }
#pragma unroll
  for (int n = 0; n < C::kStream / 8; ++n) {
    const uint32_t at = (n / kSteps) * C::kTChunk + rows + (n % kSteps) * 32;
    wgmma_rs<Tf32, C::kN>(part, xh[n], desc_k<C::kTRow / 2>(t_hi + at));
  }
  wgmma_commit();
}

// Store rows r0 and r0 + 8 (< n) of the accumulators [64 x D] at `base`
// (row stride `row_stride` floats).
template <class C>
__device__ __forceinline__ void store_rows(
    float* base, int64_t row_stride,
    const float (&acc)[C::D / C::kN][C::kN / 2], int r0, int n, int t) {
  constexpr int kN = C::kN;
#pragma unroll
  for (int c = 0; c < C::D / kN; ++c) {
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

// Tensor map of an fp32 [B, N, H, D] tensor (element strides s: batch,
// seq, head) with boxes of `rows` rows and kNat columns.
template <int D>
int make_f32_map(CUtensorMap* map, const void* ptr, int B, int N, int H,
                 const int64_t (&s)[3], int rows) {
  constexpr int kNat = D < 32 ? D : 32;
  return make_map<Tf32, kNat>(map, ptr, B, N, H, D, s[0], s[1], s[2], rows);
}

}  // namespace flash_f32
