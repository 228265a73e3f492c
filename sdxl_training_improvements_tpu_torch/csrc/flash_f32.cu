// Flash-attention forward in fp32 for Hopper (sm_90a), on the tensor cores:
// fp32 q, k, v in, fp32 out and lse = m + log l (training.mixed_precision =
// "no").  Its backward, dq and dk/dv, is flash_bwd_f32.cu; the two share
// their tiles, splitting pass and products (flash_f32_common.cuh).
//
// Replaces the Pallas kernel `_fwd_kernel` of
// sdxl_training_improvements_tpu/ops/flash_attention.py for fp32 inputs,
// where it multiplies in fp32 (`preferred_element_type` with fp32
// operands): a block per (128-row q tile, batch*head), looping over the kv
// tiles with an online softmax, as the Pallas kernel loops.
//
// Split TF32.  wgmma has no fp32 operands, and TF32 keeps 10 mantissa bits.
// Every operand enters as two TF32 parts, hi = rna(x) and lo = rna(x - hi)
// (hopper.cuh: Tf32), and every product as three TF32 products into one
// accumulator, the two small ones first: lo_a hi_b, hi_a lo_b, hi_a hi_b,
// about 2^-21 of relative accuracy against fp32's 2^-24.  S's absolute
// error becomes P's relative error through exp(S * scale - m).
//
// Bound: 4*S*T*D flops at three TF32 products each, 495 / 3 = 165 TFLOP/s
// of fp32-accurate products (0.52 ms at B2 S=T=4096 H10 D64); at T = 77
// the bytes of q and out bound it instead.
//
// Design, the dq kernel of flash_bwd_f32.cu without its dO operand:
//
// * four warpgroups a block: two consumers of 64 q rows each and two
//   producers, whose first warp issues TMA and whose other seven warps split
//   the streamed tiles; setmaxnreg gives the consumers 216 registers and
//   the producers 40.  With the backward's one producer (three splitting
//   warps) the consumers waited for the splitting pass;
// * q arrives once by TMA, raw; each k step of S = q k^T the consumers load
//   their A fragments from it and split them in registers (RS wgmma);
// * k and v arrive by TMA in kStream-row tiles (64, 32 at D = 128) through
//   a ring of kStages stages.  The splitting warps turn k, in place, into
//   its hi part with its lo part beside it (S's B operand, K-major as TMA
//   lands it), and write v transposed, hi and lo, in the order of the A
//   fragments: O += P v contracts over the kv rows, and TF32 wgmma reads
//   both operands K-major only;
// * the online softmax runs on the S accumulators: columns >= T set to
//   -inf before the row max, the max and the row sum over a quad's four
//   threads (two shuffles), P = expf(S * scale - m) with the accurate expf;
// * P is split on the accumulator layout and is the A operand of P v, which
//   goes into a fresh accumulator each kv tile (the tensor cores add by
//   truncation, and O's sum runs over all of T); the running O is rescaled
//   by alpha = expf(m_old - m_new) while that product runs, then the fresh
//   one is added by FADD;
// * rows >= S are never stored (TMA fills q rows >= S and k, v rows >= T
//   with zeros); no atomics, so two launches give bit-equal results.
//
// Shared memory per block (a build fact, `Cfg`): q (128 x D fp32) and per
// stage k raw then hi, v raw, k lo, v^T hi, v^T lo, each kStream x D fp32;
// at D = 64, 32 KB + 2 x 80 KB.
//
// Inputs are read through (batch, seq, head) element strides with a unit
// head-dim stride (the TMA maps); the output is written through its own
// strides.  C interface for ctypes; the launcher returns the cudaError_t of
// its launch (or hopper::kEncodeError + the CUresult of a tensor map it
// cannot build).

#include "flash_f32_common.cuh"

namespace {

using namespace flash_f32;

constexpr int stream_rows(int d) { return d <= 64 ? 64 : 32; }

// per stage: k raw then hi (0) | v raw (1) | k lo (2) | v^T hi (3), v^T lo
// (4); P v kN columns at a time (64 at D = 128); two producer warpgroups
// (224 splitting threads)
template <int D>
struct Cfg : Geometry<D, stream_rows(D), 1, 5, 0, D <= 64 ? D : 64, 2> {
  __host__ __device__ static constexpr bool natural(int x) { return x == 0; }
  __host__ __device__ static constexpr int lo_slot(int) { return 2; }
  __host__ __device__ static constexpr bool transposed(int x) {
    return x == 1;
  }
  __host__ __device__ static constexpr int t_slot(int) { return 3; }
};

struct Strides {  // (batch, seq, head) element strides
  int64_t q[3], k[3], v[3], o[3];
};

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// S = q k^T over D (64 x kStream): q the consumer's own rows (split
// fragments from the own tile), k a natural streamed tile as its hi and lo
// parts; each k step's small products before its hi * hi, one k step's
// fragments loaded while the last one's products run.  Returns with the
// product complete.
template <class C>
__device__ __forceinline__ void scores(const Smem<C>& sm, int row, int t,
                                       float (&s)[C::kStream / 2],
                                       uint32_t own, uint32_t k_hi,
                                       uint32_t k_lo) {
  constexpr int kStream = C::kStream;
#pragma unroll
  for (int i = 0; i < kStream / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < C::D / 8; ++kk) {
    uint32_t qh[4], ql[4];
    own_fragment<C>(sm, own, row, kk, t, qh, ql);
    const uint64_t bh = nat_desc<C>(k_hi, kk);
    wgmma_fence();
    wgmma_rs<Tf32, kStream>(s, ql, bh);
    wgmma_rs<Tf32, kStream>(s, qh, nat_desc<C>(k_lo, kk));
    wgmma_rs<Tf32, kStream>(s, qh, bh);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_operands(s);
}

// x over the four threads of a quad (the threads holding one row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffff, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffff, x, 1);
  return x + __shfl_xor_sync(0xffffffff, x, 2);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
flash_f32_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     float* __restrict__ o, float* __restrict__ lse, int H,
                     int S, int T, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                     float scale) {
  using C = Cfg<D>;
  constexpr int kStream = C::kStream;
  constexpr int kN = C::kN;
  extern __shared__ unsigned char smem_raw[];
  const Smem<C> sm(smem_raw);
  const int m0 = blockIdx.x * kOwn;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int n_tiles = (T + kStream - 1) / kStream;

  const int wg = threadIdx.x / 128;
  if (wg >= 2) {  // producers: own q; streamed k, v
    setmaxnreg_dec<40>();
    const int u = threadIdx.x - 256;
    if (u == 0) {
      load_own<C>(sm, &q_map, nullptr, h, m0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % C::kStages;
        mbar_wait(sm.empty(st), ((j / C::kStages) & 1) ^ 1);
        load_stream<C>(sm, st, &k_map, &v_map, h, j * kStream, b);
      }
    } else if (u >= 32) {
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % C::kStages;
        mbar_wait(sm.raw_full(st), (j / C::kStages) & 1);
        split_stage<C>(sm, st, u - 32);
        fence_proxy_async();
        mbar_arrive(sm.split_full(st));
      }
    }
  } else {  // consumers: warpgroup wg owns q rows [wg * 64, wg * 64 + 64)
    setmaxnreg_inc<216>();
    const int tid = threadIdx.x % 128;
    const int lane = tid & 31;
    const int t = lane & 3;
    const int row = wg * 64 + (tid >> 5) * 16 + (lane >> 2);
    const int r0 = m0 + row;

    float acc[D / kN][kN / 2];
#pragma unroll
    for (int c = 0; c < D / kN; ++c) {
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) acc[c][i] = 0.f;
    }
    // running max and (this thread's part of the) sum of rows r0, r0 + 8
    float m[2] = {-inf(), -inf()}, l[2] = {0.f, 0.f};
    float s[kStream / 2];
    uint32_t ph[kStream / 8][4], pl[kStream / 8][4];

    mbar_wait(sm.own_full(), 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % C::kStages;
      mbar_wait(sm.split_full(st), (j / C::kStages) & 1);
      scores<C>(sm, row, t, s, sm.own(0), sm.tile(st, 0), sm.tile(st, 2));
      // s[4 n + e]: row r0 (e < 2) or r0 + 8, kv column n0 + 8 n + 2 t +
      // e % 2
      const int n0 = j * kStream;
      if (n0 + kStream <= T) {
#pragma unroll
        for (int i = 0; i < kStream / 2; ++i) s[i] *= scale;
      } else {
#pragma unroll
        for (int i = 0; i < kStream / 2; ++i) {
          const int col = n0 + 8 * (i / 4) + 2 * t + (i & 1);
          s[i] = col < T ? s[i] * scale : -inf();
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kStream / 2; ++i) {
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx[e] = quad_max(mx[e]);
        alpha[e] = expf(m[e] - mx[e]);
        m[e] = mx[e];
      }
#pragma unroll
      for (int i = 0; i < kStream / 2; ++i) {
        s[i] = expf(s[i] - mx[(i >> 1) & 1]);
        sum[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) l[e] = l[e] * alpha[e] + sum[e];
      acc_fragments<kStream>(s, ph, pl);
      fence_operands(ph);
      fence_operands(pl);
#pragma unroll
      for (int c = 0; c < D / kN; ++c) {  // O = alpha O + P v
        float part[kN / 2];
        issue_over_stream<C>(part, ph, pl, sm.tile(st, 3), sm.tile(st, 4),
                             c);
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) acc[c][i] *= alpha[(i >> 1) & 1];
        wgmma_wait<0>();
        fence_operands(part);
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) acc[c][i] += part[i];
      }
      mbar_arrive(sm.empty(st));
    }
    float inv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l[e] = quad_sum(l[e]);
      inv[e] = 1.f / l[e];
    }
#pragma unroll
    for (int c = 0; c < D / kN; ++c) {
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) acc[c][i] *= inv[(i >> 1) & 1];
    }
    store_rows<C>(o + b * o_sb + h * o_sh, o_ss, acc, r0, S, t);
    if (t == 0) {
      float* lse_rows = lse + static_cast<int64_t>(bh) * S;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (r0 + 8 * e < S) lse_rows[r0 + 8 * e] = m[e] + logf(l[e]);
      }
    }
  }
}

// strides: 4 (batch, seq, head) triples in the order q, k, v, o.
Strides unpack(const int64_t* s) {
  Strides st;
  int64_t* dst[4] = {st.q, st.k, st.v, st.o};
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 3; ++j) dst[i][j] = s[3 * i + j];
  }
  return st;
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int H, int S, int T, const Strides& st,
               float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap q_map, k_map, v_map;
  int rc = make_f32_map<D>(&q_map, q, B, S, H, st.q, kOwn);
  if (rc == 0) rc = make_f32_map<D>(&k_map, k, B, T, H, st.k, C::kStream);
  if (rc == 0) rc = make_f32_map<D>(&v_map, v, B, T, H, st.v, C::kStream);
  if (rc != 0) return rc;
  static uint64_t smem_allowed = 0;  // devices where the limit is raised
  cudaError_t e =
      allow_smem(flash_f32_fwd_kernel<D>, C::kSmem, smem_allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((S + kOwn - 1) / kOwn, B * H);
  flash_f32_fwd_kernel<D><<<grid, C::kThreads, C::kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<float*>(o), static_cast<float*>(lse),
      H, S, T, st.o[0], st.o[1], st.o[2], scale);
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
